"""Cross-model parity on a 2D brain-atlas slice: TumorGrowth (per-tissue
dict coefficients) vs TumorGrowthBrain (per-tissue parameters).

Counterpart of ``examples/comparison_2D_atlas.py`` (reference
``test_case_comparison_2D_atlas.py``, l.33-206): both models run the same
problem on the same mesh; the Comparison harness reports per-step
errornorms (should be ~machine precision — the reference's own parity
claim, simulation_tumor_growth_brain.py:12-15).  At float32 the
errornorms relative to the field's norm are held to 1e-4.

Run: ``python -m glimslib_tpu_torch.example_scripts.comparison_2D_atlas``
(``--atlas NX NY NZ --z`` set the synthetic atlas and its slice).
"""

import sys

from glimslib_tpu_torch.example_scripts._comparison import compare, run_both
from glimslib_tpu_torch.example_scripts.example_config import (
    example_out, parser, resolve, synthetic_atlas_path,
)
from glimslib_tpu_torch.utils import data_io as dio
from glimslib_tpu_torch.utils.profiling import Tracer


def main(argv=None, device=None, dtype=None, plot=True, out_dir=None, plain=False):
    """Run the script; returns the comparison columns, the limit held,
    both models (``brain``, ``uniform``) and their final fields (``u``,
    ``c``: the brain model's; ``u_uniform``, ``c_uniform``) and the
    seconds by stage.
    ``plain=True`` runs the models' plain torch path; ``plot`` is
    unused."""
    p = parser(__doc__)
    p.add_argument("--atlas", type=int, nargs=3, default=(64, 64, 24),
                   metavar=("NX", "NY", "NZ"))
    p.add_argument("--z", type=int, default=12, help="the atlas slice")
    args = p.parse_args([] if argv is None else argv)
    device, dtype, plot = resolve(args, device, dtype, plot)
    tracer = Tracer()

    # atlas slice -> pixel-lattice mesh + label function (reference l.33-60)
    with tracer.scope("domain"):
        atlas = synthetic_atlas_path(example_out("data", out_dir), *args.atlas)
        mesh, labels = dio.get_labelfunction_from_image(atlas, z_slice=args.z)
    out = example_out("comparison_2D_atlas", out_dir)
    brain, uni = run_both(mesh, labels, out, tracer, device, dtype, plain)
    cols, rtol = compare(brain, uni, out, tracer, dtype, ["concentration"])
    print("parity confirmed ->", out)
    return dict(columns=cols, rtol=rtol, u=brain.solution[0], c=brain.solution[1],
                u_uniform=uni.solution[0], c_uniform=uni.solution[1],
                brain=brain, uniform=uni, stages=tracer.summary())


if __name__ == "__main__":
    main(sys.argv[1:])
