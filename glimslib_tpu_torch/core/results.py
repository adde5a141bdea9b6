"""Results management: in-memory time series and the series store
(counterpart of ``glimslib_tpu/core/results.py``).

``TimeSeriesDataTimePoint``, ``TimeSeriesData`` and ``Results``' per-step
output (``save_method`` None, ``"vtk"``: a VTU a step and a PVD series,
``"xdmf"``: XDMF + HDF5, which needs h5py) are the reference's code, byte
for byte apart from imports and one check: ``save_solution_start``
refuses ``"xdmf"`` when h5py does not import, before a simulation runs.
Fields are numpy arrays on the host.

The whole-series store is a numpy ``.npz`` archive, not HDF5 (the card's
host has no h5py; see ``utils/data_io.py``): the reference's layout as
keys, ``mesh/points``, ``mesh/cells`` and per recorded step
``series/<name>/step_XXXXX/subspace_<sid>`` with ``.../time``,
``.../time_step`` and ``.../recording_step`` beside them, at the
reference's path with the extension swapped (``solution_timeseries.npz``).
The method names stay (``save_to_hdf5``, ``save_solution_hdf5``, ...).
The Orbax checkpoint (a JAX library) is not ported: its methods raise.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, Optional

import numpy as np

from glimslib_tpu_torch.utils import data_io

logger = logging.getLogger(__name__)


def _refuse_unwritable(method):
    """Raise when the per-step output ``method`` cannot be written here
    (``"xdmf"`` needs h5py): at the start of a run, before any step, not
    at its first write."""
    if method != "xdmf":
        return
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        raise ImportError(
            'save_method="xdmf" writes XDMF + HDF5 and needs h5py, which does not '
            'import here: pass save_method="vtk" (a VTU a step and a PVD series) '
            'or None (no per-step files)') from e

_STEP_KEY = re.compile(r"series/(.+)/step_(\d+)/subspace_(\d+)$")
_ORBAX = ("the Orbax checkpoint is a JAX library and is not ported: use the "
          "series store (save_solution_hdf5 / load_solution_hdf5, a .npz "
          "archive)")


class TimeSeriesDataTimePoint:
    """One recorded step (reference helper_classes.py:1083-1126)."""

    def __init__(self, time, time_step, recording_step, fields: Dict[int, np.ndarray]):
        self.time = float(time)
        self.time_step = int(time_step)
        self.recording_step = int(recording_step)
        self.fields = {k: np.array(v) for k, v in fields.items()}  # deep copy

    def get_field(self, subspace_id):
        return self.fields[subspace_id]


class TimeSeriesData:
    """Series of recorded steps for one named solution
    (reference helper_classes.py:1128-1254)."""

    def __init__(self, name="solution", functionspace=None):
        self.name = name
        self.functionspace = functionspace
        self.data: Dict[int, TimeSeriesDataTimePoint] = {}

    def add_observation(self, field_dict, time, time_step, recording_step, replace=False):
        if recording_step in self.data and not replace:
            logger.warning("recording step %d already exists", recording_step)
            return
        self.data[recording_step] = TimeSeriesDataTimePoint(
            time, time_step, recording_step, field_dict
        )

    def get_observation(self, recording_step) -> Optional[TimeSeriesDataTimePoint]:
        return self.data.get(recording_step)

    def get_most_recent_observation(self):
        if not self.data:
            return None
        return self.data[max(self.data)]

    def get_solution_function(self, recording_step, subspace_id=None):
        """Reference helper_classes.py:1159-1181: return a recorded field,
        whole mixed dict or one subspace."""
        obs = self.get_observation(recording_step)
        if obs is None:
            return None
        if subspace_id is None:
            return obs.fields
        return obs.fields[subspace_id]

    def get_recording_steps(self):
        return sorted(self.data.keys())

    def get_time(self, recording_step):
        obs = self.get_observation(recording_step)
        return obs.time if obs else None

    def __len__(self):
        return len(self.data)


class TimeSeriesMultiData:
    """Multiple named time series + whole-series HDF5 I/O
    (reference helper_classes.py:1256-1308)."""

    def __init__(self):
        self._series: Dict[str, TimeSeriesData] = {}

    def register_time_series(self, name, functionspace=None):
        if name not in self._series:
            self._series[name] = TimeSeriesData(name, functionspace)

    def get_time_series(self, name) -> Optional[TimeSeriesData]:
        return self._series.get(name)

    def get_all_time_series(self):
        return dict(self._series)

    def add_observation(self, name, field_dict, time, time_step, recording_step,
                        replace=False):
        self._series[name].add_observation(
            field_dict, time, time_step, recording_step, replace
        )

    def get_solution_function(self, name, recording_step, subspace_id=None):
        return self._series[name].get_solution_function(recording_step, subspace_id)

    # -- the series store (.npz with the reference's HDF5 layout) ---------

    def save_to_hdf5(self, path, mesh=None):
        """Every series to one archive; returns its path."""
        arrays = {}
        if mesh is not None:
            arrays["mesh/points"] = mesh.points
            arrays["mesh/cells"] = mesh.cells
        for name, series in self._series.items():
            for rstep in series.get_recording_steps():
                obs = series.get_observation(rstep)
                key = f"series/{name}/step_{rstep:05d}"
                arrays[f"{key}/time"] = np.float64(obs.time)
                arrays[f"{key}/time_step"] = np.int64(obs.time_step)
                arrays[f"{key}/recording_step"] = np.int64(obs.recording_step)
                for sid, arr in obs.fields.items():
                    arrays[f"{key}/subspace_{sid}"] = arr
        path = data_io._write_npz(path, arrays)
        logger.info("saved time series to %s", path)
        return path

    def load_from_hdf5(self, path):
        store = data_io._read_npz(path)
        steps = {}
        for key in sorted(store):
            m = _STEP_KEY.match(key)
            if m:
                name, rstep, sid = m.group(1), int(m.group(2)), int(m.group(3))
                steps.setdefault((name, rstep), {})[sid] = store[key]
        for (name, rstep), fields in sorted(steps.items()):
            self.register_time_series(name)
            key = f"series/{name}/step_{rstep:05d}"
            self._series[name].add_observation(
                fields,
                float(store[f"{key}/time"]),
                int(store[f"{key}/time_step"]),
                int(store[f"{key}/recording_step"]),
                replace=True,
            )

    def save_to_orbax(self, path, mesh=None):
        raise NotImplementedError(_ORBAX)

    def load_from_orbax(self, path):
        raise NotImplementedError(_ORBAX)

    @staticmethod
    def read_mesh_hdf5(path):
        from glimslib_tpu_torch.core.mesh import Mesh

        store = data_io._read_npz(path)
        if "mesh/points" not in store:
            return None
        return Mesh.from_arrays(store["mesh/points"], store["mesh/cells"])


class Results:
    """Owns the 'solution' time series and the on-disk output lifecycle
    (reference helper_classes.py:1312-1453)."""

    def __init__(self, functionspace, subdomains=None, output_dir="."):
        self._functionspace = functionspace
        self._subdomains = subdomains
        self.output_dir = output_dir
        self.data = TimeSeriesMultiData()
        self.data.register_time_series("solution", functionspace)
        self._vtk_series = []  # (recording_step, time, filename)

    @property
    def mesh(self):
        return self._functionspace.mesh

    def add_to_results(self, current_sim_time, time_step, recording_step, fields):
        """Record a solution (deep-copied), reference helper_classes.py:1336-1338."""
        fields = {k: np.asarray(v) for k, v in fields.items()}
        self.data.add_observation(
            "solution", fields, current_sim_time, time_step, recording_step,
            replace=True,
        )

    def get_result(self, recording_step):
        return self.data.get_solution_function("solution", recording_step)

    def get_recording_steps(self):
        return self.data.get_time_series("solution").get_recording_steps()

    # -- per-step persistence (helper_classes.py:1360-1409) -----------------

    def save_solution_start(self, method="xdmf", clear_all=False):
        _refuse_unwritable(method)
        if clear_all and os.path.isdir(self.output_dir):
            import shutil

            shutil.rmtree(self.output_dir, ignore_errors=True)
        if method is not None:
            os.makedirs(self.output_dir, exist_ok=True)
        self._vtk_series = []

    def save_solution(self, recording_step, time, fields=None, method="xdmf"):
        if method is None:
            return
        if fields is None:
            fields = self.get_result(recording_step)
        if fields is None:
            return
        names = self._functionspace.get_subspace_names()
        n_pts = self.mesh.n_nodes
        point_data = {}
        for sid, arr in fields.items():
            arr = np.asarray(arr)
            if arr.ndim == 1 and len(arr) > n_pts:
                # P2 field: extract the vertex-dof values (equal to the
                # function's vertex values) via the shared interleaved
                # layout (ops/p2.py p2_dof_layout)
                from glimslib_tpu_torch.ops.p2 import p2_dof_layout

                _, rank, _ = p2_dof_layout(self.mesh)
                arr = arr[rank[:n_pts]]
            point_data[names.get(sid, f"subspace_{sid}")] = arr
        if method == "vtk":
            from glimslib_tpu_torch.utils import vtk_utils

            fname = os.path.join(
                self.output_dir, f"solution_{recording_step:06d}.vtu"
            )
            vtk_utils.write_vtu(fname, self.mesh.points, self.mesh.cells, point_data)
            self._vtk_series.append((recording_step, time, os.path.basename(fname)))
        elif method == "xdmf":
            from glimslib_tpu_torch.utils import vtk_utils

            fname = os.path.join(self.output_dir, "solution.h5")
            vtk_utils.append_xdmf_step(
                os.path.join(self.output_dir, "solution.xdmf"),
                fname,
                self.mesh,
                point_data,
                recording_step,
                time,
            )
        else:
            raise ValueError(f"unknown save method {method!r}")

    def save_solution_end(self, method="xdmf"):
        if method == "vtk" and self._vtk_series:
            from glimslib_tpu_torch.utils import vtk_utils

            vtk_utils.write_pvd(
                os.path.join(self.output_dir, "solution.pvd"), self._vtk_series
            )

    def save_label_function(self):
        """Reference helper_classes.py:1406-1409."""
        if self._subdomains is None or self._subdomains.label_function is None:
            return
        from glimslib_tpu_torch.utils import vtk_utils

        os.makedirs(self.output_dir, exist_ok=True)
        vtk_utils.write_vtu(
            os.path.join(self.output_dir, "label_function.vtu"),
            self.mesh.points,
            self.mesh.cells,
            {"label": np.asarray(self._subdomains.label_function)},
            cell_data={"subdomains": np.asarray(self._subdomains.cell_labels)},
        )

    # -- whole-series store (helper_classes.py:1441-1445) -------------------

    def save_solution_hdf5(self, path=None):
        """The series store; returns the archive's path
        (``solution_timeseries.npz`` in ``output_dir`` by default)."""
        path = path or os.path.join(self.output_dir, "solution_timeseries.h5")
        return self.data.save_to_hdf5(path, mesh=self.mesh)

    def load_solution_hdf5(self, path):
        self.data.load_from_hdf5(path)

    def save_solution_orbax(self, path=None):
        raise NotImplementedError(_ORBAX)

    def load_solution_orbax(self, path):
        raise NotImplementedError(_ORBAX)
