"""Embedded file resources.

Equivalent of GSLAM/GSLAM/core/FileResource.h (:9-111): register binary
blobs under virtual paths, fetch them at runtime, export them to real files,
and generate a Python module embedding a file's bytes (the reference
generates a C++ header) — used by the reference to ship the `.gbow`
vocabulary inside the binary.
"""
from __future__ import annotations

import base64
import os
import threading
from typing import Dict, Optional

_resources: Dict[str, bytes] = {}
_lock = threading.Lock()


def register(name: str, data: bytes):
    """FileResource::Register."""
    with _lock:
        _resources[name] = bytes(data)


def get(name: str) -> Optional[bytes]:
    """FileResource::getResource."""
    with _lock:
        return _resources.get(name)


def export(name: str, path: str) -> bool:
    """FileResource::exportResourceFile."""
    data = get(name)
    if data is None:
        return False
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return True


def generate_module(src_file: str, resource_name: str, out_py: str) -> bool:
    """Generate an importable module embedding `src_file` (the reference's
    exportResourceFile generating a C++ source, FileResource.h:60+).
    Importing the module registers the resource."""
    with open(src_file, "rb") as f:
        data = f.read()
    b85 = base64.b85encode(data).decode()
    chunks = [b85[i:i + 76] for i in range(0, len(b85), 76)]
    body = "\n".join(f'    "{c}"' for c in chunks)
    with open(out_py, "w") as f:
        f.write('"""Auto-generated embedded resource (core/resource.py).'
                '"""\nimport base64\n\n'
                "from pislamfusion_tpu_torch.core import resource\n\n"
                f"NAME = {resource_name!r}\n"
                f"_DATA = (\n{body}\n)\n\n"
                "resource.register(NAME, base64.b85decode(_DATA))\n")
    return True
