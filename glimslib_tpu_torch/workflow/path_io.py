# Copy of glimslib_tpu/workflow/path_io.py (numpy only). The code is kept
# byte for byte apart from imports, which point into glimslib_tpu_torch so
# that the port never imports the JAX package.
"""BIDS-style structured output paths, driven by a path-pattern config.

Rebuild of reference ``optimization_workflow/path_io.py`` +
``path_io_config.json`` without the grabbit dependency: path construction
is driven by the same grabbit-style pattern grammar loaded from a JSON
config (reference path_io.py:12-33), defaulting to the bundled
``path_io_config.json`` whose pattern

    [{processing}/][{datasource}][_{datatype}][_{content}][_{domain}]
    [_{frame}][_{dim}d][.{extension}]

reproduces the reference's directory layouts file-for-file.  Pass
``path_to_bids_config`` to use a custom entity scheme/pattern.

Pattern grammar (the subset grabbit's ``build_path`` uses): literal text,
``{entity}`` placeholders, and ``[...]`` optional groups — a group is
emitted only when every placeholder inside it has a value.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

from glimslib_tpu_torch.utils import file_utils as fu

_DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "path_io_config.json"
)

_TOKEN = re.compile(r"\[([^\[\]]*)\]|([^\[\]]+)")
_PLACEHOLDER = re.compile(r"\{(\w+)\}")


def build_path_from_pattern(pattern: str, entities: dict) -> str:
    """Instantiate a grabbit-style path pattern from an entity dict.

    Raises ``KeyError`` if a mandatory (non-bracketed) placeholder has no
    value; silently drops optional groups with missing values."""
    out = []
    for optional, literal in _TOKEN.findall(pattern):
        if literal:
            def _sub(m):
                val = entities.get(m.group(1))
                if val is None:
                    raise KeyError(
                        f"mandatory path entity {m.group(1)!r} missing"
                    )
                return str(val)

            out.append(_PLACEHOLDER.sub(_sub, literal))
        else:
            names = _PLACEHOLDER.findall(optional)
            if names and all(entities.get(n) is not None for n in names):
                out.append(
                    _PLACEHOLDER.sub(
                        lambda m: str(entities[m.group(1)]), optional
                    )
                )
    return "".join(out)


class PathIO:
    def __init__(self, data_root, path_to_bids_config=None):
        self.path_to_bids_config = path_to_bids_config or _DEFAULT_CONFIG
        with open(self.path_to_bids_config) as f:
            self.bids_config = json.load(f)
        self.path_patterns = self.bids_config.get("default_path_patterns", [])
        self.entity_names = [
            e["name"] for e in self.bids_config.get("entities", [])
        ]
        self.data_root = data_root
        fu.ensure_dir_exists(data_root)

    def create_path(self, path_pattern_list=None, abs_path=True, create=True,
                    with_ext=True, extension=None, **entities):
        patterns = path_pattern_list or self.path_patterns
        if extension is not None and with_ext:
            entities = dict(entities, extension=extension)
        else:
            entities.pop("extension", None)
        path = None
        err = None
        for pattern in patterns:
            try:
                path = build_path_from_pattern(pattern, entities)
                break
            except KeyError as e:
                err = e
        if path is None:
            raise err or ValueError("no path pattern configured")
        if abs_path:
            path = os.path.join(self.data_root, path)
        if create:
            fu.ensure_dir_exists(os.path.dirname(path))
        return path

    # -- typed helpers (reference path_io.py:47-77) --------------------------

    def create_image_path(self, processing, datasource, domain="full",
                          frame="reference", datatype="image", content="T1",
                          extension="mha", abs_path=True, create=True, **kw):
        return self.create_path(
            processing=processing, datasource=datasource, domain=domain,
            frame=frame, datatype=datatype, content=content,
            extension=extension, abs_path=abs_path, create=create, **kw,
        )

    def create_fenics_path(self, processing, datasource, domain="full",
                           frame="reference", datatype="fenics", content="mesh",
                           extension="h5", abs_path=True, create=True, **kw):
        return self.create_path(
            processing=processing, datasource=datasource, domain=domain,
            frame=frame, datatype=datatype, content=content,
            extension=extension, abs_path=abs_path, create=create, **kw,
        )

    def create_trafo_path(self, processing, datasource="registration",
                          domain=None, frame="ref2def", datatype="trafo",
                          content="regaffine", extension="mat", abs_path=True,
                          create=True, **kw):
        return self.create_path(
            processing=processing, datasource=datasource, domain=domain,
            frame=frame, datatype=datatype, content=content,
            extension=extension, abs_path=abs_path, create=create, **kw,
        )

    def create_params_path(self, processing, datasource="simulation",
                           domain=None, frame=None, datatype="parameterset",
                           content=None, extension="pkl", abs_path=True,
                           create=True, **kw):
        return self.create_path(
            processing=processing, datasource=datasource, domain=domain,
            frame=frame, datatype=datatype, content=content,
            extension=extension, abs_path=abs_path, create=create, **kw,
        )
