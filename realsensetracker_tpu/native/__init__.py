"""Native (C++) host components, loaded via ctypes.

The compute path is JAX/XLA; the host runtime around it -- clip
codec, PNG depth decoding, unbounded voxel-hash world model -- is C++
(native/src/*.cpp), mirroring where the reference is native (librealsense
capture, protobuf serde, hash-map accumulator). Python fallbacks exist for
every function; `build()` compiles the library with cmake+make on demand.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_LIB = None
_LIB_NAME = "librstpu_native.so"


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _lib_paths() -> list[str]:
    root = _repo_root()
    return [
        os.path.join(os.path.dirname(os.path.abspath(__file__)), _LIB_NAME),
        os.path.join(root, "native", "build", _LIB_NAME),
    ]


def build(force: bool = False) -> str:
    """Compile the native library (cmake + make). Returns the .so path."""
    root = _repo_root()
    build_dir = os.path.join(root, "native", "build")
    out = os.path.join(build_dir, _LIB_NAME)
    if os.path.exists(out) and not force:
        return out
    os.makedirs(build_dir, exist_ok=True)
    subprocess.run(
        ["cmake", "-DCMAKE_BUILD_TYPE=Release", ".."],
        cwd=build_dir, check=True, capture_output=True,
    )
    subprocess.run(["make", "-j4"], cwd=build_dir, check=True, capture_output=True)
    return out


def load(auto_build: bool = True):
    """Load (building if needed) the native library; raises if unavailable."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = next((p for p in _lib_paths() if os.path.exists(p)), None)
    if path is None and auto_build:
        path = build()
    if path is None:
        raise OSError("native library not built")
    lib = ctypes.CDLL(path)
    if not hasattr(lib, "rstpu_abi_version") or lib.rstpu_abi_version() < 5:
        # Stale build from an older source revision: rebuild in place.
        if not auto_build:
            raise OSError("native library ABI too old")
        path = build(force=True)
        lib = ctypes.CDLL(path)
    # Signatures.
    lib.rsc_read_header.restype = ctypes.c_int
    lib.rsc_read_frames.restype = ctypes.c_int
    lib.rsc_read_colors.restype = ctypes.c_int
    lib.rsc_write_clip.restype = ctypes.c_int
    lib.png16_read_header.restype = ctypes.c_int
    lib.png16_decode.restype = ctypes.c_int
    lib.png16_decode_batch.restype = ctypes.c_int
    lib.png16_decode_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
    ]
    lib.voxel_map_create.restype = ctypes.c_void_p
    lib.voxel_map_create.argtypes = [ctypes.c_float]
    lib.voxel_map_destroy.argtypes = [ctypes.c_void_p]
    lib.voxel_map_add.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.voxel_map_size.restype = ctypes.c_int64
    lib.voxel_map_size.argtypes = [ctypes.c_void_p]
    lib.voxel_map_extract.restype = ctypes.c_int64
    lib.voxel_map_extract.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    _LIB = lib
    return lib
