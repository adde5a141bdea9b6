"""Run every example script in order (the counterpart of
``examples/run_all_examples.sh``):

    python -m glimslib_tpu_torch.example_scripts [--device cpu --dtype float64] [--no-plot] [--out-dir DIR]

On the card (the default, float32) pass ``--no-plot`` where matplotlib is
absent: the two plotting scripts raise without it.
"""

import importlib
import os
import sys

from glimslib_tpu_torch.example_scripts import RUNS
from glimslib_tpu_torch.example_scripts.example_config import (
    example_out, labelled_slice_vtu, parser, synthetic_atlas_path,
)


def convert_argv(out_dir=None):
    """convert_vtu_mesh_to_hdf5's arguments: a VTU of the synthetic atlas's
    slice 12 with its subdomains, written here, and the store beside it."""
    out = example_out("convert_vtu_mesh_to_hdf5", out_dir)
    atlas = synthetic_atlas_path(example_out("data", out_dir))
    src = labelled_slice_vtu(os.path.join(out, "atlas_slice.vtu"), atlas, 12)
    return [src, os.path.join(out, "atlas_slice.h5")]


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--out-dir", default=None)
    args = p.parse_args([] if argv is None else argv)
    common = []
    if args.device:
        common += ["--device", args.device]
    if args.dtype:
        common += ["--dtype", args.dtype]
    if args.no_plot:
        common.append("--no-plot")
    for name, script_argv in RUNS:
        if script_argv is None:
            script_argv = convert_argv(args.out_dir)
        print(f"== {name} {' '.join(script_argv)}", flush=True)
        module = importlib.import_module(f"glimslib_tpu_torch.example_scripts.{name}")
        module.main(script_argv + common, out_dir=args.out_dir)
    print("ALL EXAMPLES OK")


if __name__ == "__main__":
    main(sys.argv[1:])
