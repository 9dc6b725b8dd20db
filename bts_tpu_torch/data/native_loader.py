"""ctypes binding for the native C++ data plane (``csrc/btsdata.cc``).

Counterpart of ``bts_tpu/data/native_loader.py``.  ``csrc/btsdata.cc`` is
the port's copy of ``native/btsdata.cc``: libpng/libjpeg decode with the
fixed-geometry crop fused into the row copy, plus a ``std::thread`` pool that
keeps whole batches decoded ahead of the training step.  The library is
built with ``g++`` at first use into the port's ``build/`` directory
(``ops/_build.py::build_host``: content digest, temporary file plus rename),
so concurrent test workers or torchrun ranks never write one file.

- ``decode_rgb`` / ``decode_depth``: one sample from a file, PIL-equal output
- ``decode_rgb_mem`` / ``decode_depth_mem`` / ``peek_dims``: encoded bytes
  (the ArrayRecord path, ``data/records.py``)
- ``NativeBatchLoader``: assembled uint8 / float32 batches from C++ workers

``available()`` is False when the library does not build (no compiler, no
libpng/libjpeg headers); ``unavailable_reason()`` then gives the compiler's
message, and callers fall back to PIL.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np

from bts_tpu_torch.ops import _build

CROP_NONE, CROP_KB, CROP_NYU = 0, 1, 2
LINK = ("-lpng", "-ljpeg", "-lz")

_u8p, _f32p, _i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)


@functools.lru_cache(maxsize=None)
def _load() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the library, "") or (None, why it did not build)."""
    try:
        lib = ctypes.CDLL(str(_build.build_host("btsdata", LINK).path))
    except (RuntimeError, OSError) as e:
        return None, str(e)
    c_int, c_float, c_long, c_char_p = ctypes.c_int, ctypes.c_float, ctypes.c_long, ctypes.c_char_p
    signatures = {
        "bts_decode_rgb": [c_char_p, c_int, _u8p, _i32p, _i32p],
        "bts_decode_depth": [c_char_p, c_int, c_float, _f32p, _i32p, _i32p],
        "bts_peek_dims": [_u8p, c_long, _i32p, _i32p],
        "bts_decode_rgb_mem": [_u8p, c_long, c_int, _u8p, _i32p, _i32p],
        "bts_decode_depth_mem": [_u8p, c_long, c_int, c_float, _f32p, _i32p, _i32p],
        "bts_loader_create": [ctypes.POINTER(c_char_p), ctypes.POINTER(c_char_p), _f32p, c_int, c_int,
                              c_int, c_int, c_int, c_float, c_int, c_int, c_int],
        "bts_loader_start_epoch": [ctypes.c_void_p, _i32p, c_int, c_int],
        "bts_loader_next": [ctypes.c_void_p, _u8p, _f32p, _f32p],
        "bts_loader_errors": [ctypes.c_void_p],
        "bts_loader_destroy": [ctypes.c_void_p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_void_p if name == "bts_loader_create" else (
            None if name == "bts_loader_destroy" else c_int)
    return lib, ""


def available() -> bool:
    return _load()[0] is not None


def unavailable_reason() -> str:
    """Why the library did not build ("" when it did)."""
    return _load()[1]


def _lib() -> ctypes.CDLL:
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"the native loader (csrc/btsdata.cc) is unavailable: {why}")
    return lib


def crop_shape(crop_mode: int, h: int, w: int) -> Tuple[int, int]:
    if crop_mode == CROP_KB:
        return 352, 1216
    if crop_mode == CROP_NYU:
        return 472 - 45, 608 - 43
    return h, w


def decode_rgb(path: str, crop_mode: int, out_h: int, out_w: int) -> np.ndarray:
    """Decode + crop an RGB image natively -> (out_h, out_w, 3) uint8."""
    out = np.empty((out_h, out_w, 3), np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _lib().bts_decode_rgb(path.encode(), crop_mode, out.ctypes.data_as(_u8p), ctypes.byref(h), ctypes.byref(w))
    if rc != 0 or h.value != out_h or w.value != out_w:
        raise IOError(f"native decode_rgb failed for {path} (rc={rc}, {h.value}x{w.value})")
    return out


def decode_depth(path: str, crop_mode: int, inv_scale: float, out_h: int, out_w: int) -> np.ndarray:
    """Decode + crop + scale a uint16 depth PNG natively -> (h, w) float32 m."""
    out = np.empty((out_h, out_w), np.float32)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _lib().bts_decode_depth(path.encode(), crop_mode, inv_scale, out.ctypes.data_as(_f32p),
                                 ctypes.byref(h), ctypes.byref(w))
    if rc != 0 or h.value != out_h or w.value != out_w:
        raise IOError(f"native decode_depth failed for {path} (rc={rc}, {h.value}x{w.value})")
    return out


def peek_dims(data: bytes) -> Tuple[int, int]:
    """(h, w) of an encoded PNG/JPEG payload without decoding (header parse)."""
    buf = np.frombuffer(data, np.uint8)  # no copy; the C side only reads it
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _lib().bts_peek_dims(buf.ctypes.data_as(_u8p), len(data), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"unrecognized/truncated image header ({len(data)} bytes)")
    return h.value, w.value


def decode_rgb_mem(data: bytes) -> np.ndarray:
    """Decode encoded PNG/JPEG bytes -> (h, w, 3) uint8, no crop (the
    ArrayRecord path crops downstream, as the PIL file path does)."""
    sh, sw = peek_dims(data)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((sh, sw, 3), np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _lib().bts_decode_rgb_mem(buf.ctypes.data_as(_u8p), len(data), CROP_NONE, out.ctypes.data_as(_u8p),
                                   ctypes.byref(h), ctypes.byref(w))
    if rc != 0 or h.value != sh or w.value != sw:
        raise IOError(f"native decode_rgb_mem failed (rc={rc}, {h.value}x{w.value})")
    return out


def decode_depth_mem(data: bytes) -> np.ndarray:
    """Decode uint16 depth-PNG bytes -> (h, w) float32 raw counts, no crop
    (scaling to meters happens in ``depth_from_png``, as on the PIL path;
    float32 holds every uint16 exactly)."""
    sh, sw = peek_dims(data)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((sh, sw), np.float32)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _lib().bts_decode_depth_mem(buf.ctypes.data_as(_u8p), len(data), CROP_NONE, 1.0,
                                     out.ctypes.data_as(_f32p), ctypes.byref(h), ctypes.byref(w))
    if rc != 0 or h.value != sh or w.value != sw:
        raise IOError(f"native decode_depth_mem failed (rc={rc}, {h.value}x{w.value})")
    return out


class NativeBatchLoader:
    """C++-threaded batch prefetch over a fixed sample table.

    One instance per (split, geometry).  Each epoch, Python passes the
    sample order; C++ workers decode ``prefetch`` batches ahead.  ``close``
    stops and joins the workers.
    """

    def __init__(
        self,
        image_paths: Sequence[str],
        depth_paths: Sequence[Optional[str]],
        focals: Sequence[float],
        batch: int,
        height: int,
        width: int,
        crop_mode: int,
        inv_scale: float,
        with_depth: bool = True,
        num_threads: int = 2,
        prefetch: int = 3,
    ):
        self.lib = _lib()
        n = len(image_paths)
        # the C side copies the strings; these live until the call returns
        img = (ctypes.c_char_p * n)(*[p.encode() for p in image_paths])
        dep = (ctypes.c_char_p * n)(*[(p or "").encode() for p in depth_paths])
        foc = (ctypes.c_float * n)(*[float(f) for f in focals])
        self.handle = self.lib.bts_loader_create(img, dep, foc, n, batch, height, width, crop_mode,
                                                 inv_scale, int(with_depth), num_threads, prefetch)
        self.batch, self.h, self.w = batch, height, width
        self.with_depth = with_depth
        self.num_threads = num_threads
        self._n_batches = 0
        self._errors_seen = 0

    def start_epoch(self, order: np.ndarray) -> None:
        order = np.ascontiguousarray(order, np.int32)
        usable = len(order) - (len(order) % self.batch)
        order = order[:usable]
        rc = self.lib.bts_loader_start_epoch(self.handle, order.ctypes.data_as(_i32p), usable, self.num_threads)
        if rc != 0:
            raise RuntimeError(f"start_epoch failed rc={rc}")
        self._n_batches = usable // self.batch

    def __iter__(self):
        for _ in range(self._n_batches):
            images = np.empty((self.batch, self.h, self.w, 3), np.uint8)
            depths = np.empty((self.batch, self.h, self.w), np.float32) if self.with_depth else None
            focals = np.empty((self.batch,), np.float32)
            rc = self.lib.bts_loader_next(self.handle, images.ctypes.data_as(_u8p),
                                          depths.ctypes.data_as(_f32p) if depths is not None else None,
                                          focals.ctypes.data_as(_f32p))
            if rc != 0:
                return
            # a failed decode zero-fills its sample: never train on black
            # frames, so any new failure since the last batch is fatal
            err = self.errors()
            if err != self._errors_seen:
                n_new = err - self._errors_seen
                self._errors_seen = err
                raise RuntimeError(f"native loader: {n_new} decode failure(s) (corrupt or "
                                   f"missing input files; {err} total this loader)")
            out = {"image": images, "focal": focals}
            if depths is not None:
                out["depth"] = depths
            yield out

    def errors(self) -> int:
        return self.lib.bts_loader_errors(self.handle)

    def close(self) -> None:
        if getattr(self, "handle", None):
            self.lib.bts_loader_destroy(self.handle)
            self.handle = None

    def __del__(self):
        self.close()
