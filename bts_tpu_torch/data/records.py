"""ArrayRecord shards: a training split as random-access records.

Counterpart of ``bts_tpu/data/records.py``, with the same framing and error
messages, so shards written by either package read in the other.  A record
packs the already-encoded image and depth bytes and the focal length, so a
converted split gives the same batches as its PNG tree.  Framing
(little-endian, no proto dependency):

    uint32 img_len | image PNG/JPEG bytes
    uint32 depth_len | depth uint16-PNG bytes    (depth_len == 0: no gt)
    float32 focal

Write shards with ``python -m bts_tpu_torch.tools.make_records``; point
``--filenames_file`` at a ``.array_record`` path or glob and
``BtsDataLoader`` reads records by index (the epoch order, data-parallel
rows and sample-exact resume are those of the PNG tree).  ``array_record``
and Pillow are imported where they are used, not with this module.
"""

from __future__ import annotations

import glob
import io
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np


def looks_like_records(path: str) -> bool:
    """True if a --filenames_file value names ArrayRecord shards (path or glob)."""
    return path.rstrip("*?[]").endswith((".array_record", ".arrayrecord"))


def encode_record(img_bytes: bytes, depth_bytes: Optional[bytes], focal: float) -> bytes:
    depth_bytes = depth_bytes or b""
    return b"".join((struct.pack("<I", len(img_bytes)), img_bytes,
                     struct.pack("<I", len(depth_bytes)), depth_bytes, struct.pack("<f", focal)))


def decode_record(buf: bytes, use_native: bool = True) -> Tuple[np.ndarray, Optional[np.ndarray], float]:
    """-> (uint8 HWC image, raw decoded depth PNG array or None, focal).

    The depth array holds the PNG's counts (uint16 through PIL, float32
    through the native decoder, exact either way); scaling to meters happens
    in the loader, as on the PNG-tree path.  ``use_native`` decodes through
    the C++ in-memory decoder when the library is available; PIL decodes what
    it cannot parse (e.g. paletted or 8-bit depth PNGs).
    """
    from PIL import Image

    # the framing is checked before any decode: a truncated payload fails
    # here with a framing message, not inside the decoder
    if len(buf) < 4:
        raise ValueError(f"record truncated: {len(buf)} bytes (< 4-byte header)")
    (img_len,) = struct.unpack_from("<I", buf, 0)
    off = 4
    if off + img_len + 4 > len(buf):
        raise ValueError(f"record truncated: img_len {img_len} overruns {len(buf)}-byte payload")
    native = None
    if use_native:
        from bts_tpu_torch.data import native_loader as nl

        native = nl if nl.available() else None

    img_bytes = buf[off : off + img_len]
    image = None
    if native is not None:
        try:
            image = native.decode_rgb_mem(img_bytes)
        except (IOError, ValueError):
            image = None
    if image is None:
        image = np.asarray(Image.open(io.BytesIO(img_bytes)).convert("RGB"), np.uint8)
    off += img_len
    (depth_len,) = struct.unpack_from("<I", buf, off)
    off += 4
    if off + depth_len + 4 != len(buf):
        raise ValueError(
            f"record framing mismatch: expected {off + depth_len + 4} bytes "
            f"(img {img_len} + depth {depth_len} + focal), payload has {len(buf)}"
        )
    depth = None
    if depth_len:
        depth_bytes = buf[off : off + depth_len]
        if native is not None:
            try:
                depth = native.decode_depth_mem(depth_bytes)
            except (IOError, ValueError):
                depth = None
        if depth is None:
            depth = np.array(Image.open(io.BytesIO(depth_bytes)))
    off += depth_len
    (focal,) = struct.unpack_from("<f", buf, off)
    return image, depth, focal


def write_records(samples: Sequence, out_prefix: str, shard_size: int = 1024,
                  options: str = "group_size:1") -> List[str]:
    """Pack loader Samples into ArrayRecord shards ``<prefix>-NNNNN-of-NNNNN``.

    ``group_size:1`` keeps every record independently seekable (random
    reads in a shuffled epoch).
    """
    from array_record.python.array_record_module import ArrayRecordWriter

    n_shards = max(1, (len(samples) + shard_size - 1) // shard_size)
    paths = [f"{out_prefix}-{i:05d}-of-{n_shards:05d}.array_record" for i in range(n_shards)]
    for shard_i, path in enumerate(paths):
        writer = ArrayRecordWriter(path, options)
        try:
            for s in samples[shard_i * shard_size : (shard_i + 1) * shard_size]:
                with open(s.image_path, "rb") as f:
                    img_bytes = f.read()
                depth_bytes = None
                if s.depth_path is not None:
                    with open(s.depth_path, "rb") as f:
                        depth_bytes = f.read()
                writer.write(encode_record(img_bytes, depth_bytes, s.focal))
        finally:
            writer.close()
    return paths


class RecordSource:
    """Random-access view over ArrayRecord shards, one index space: the
    loader treats it as its sample table."""

    def __init__(self, pattern: str):
        from array_record.python.array_record_data_source import ArrayRecordDataSource

        files = sorted(glob.glob(pattern)) if any(c in pattern for c in "*?[") else [pattern]
        if not files or not all(os.path.exists(f) for f in files):
            raise FileNotFoundError(f"no ArrayRecord shards match {pattern!r}")
        self._files = files
        self._source = ArrayRecordDataSource(files)

    def __len__(self) -> int:
        return len(self._source)

    def _locate(self, index: int) -> str:
        """'shard[local_index]' of a global index, for error messages; the
        global index when a shard cannot be opened again."""
        from array_record.python.array_record_module import ArrayRecordReader

        remaining = index
        try:
            for f in self._files:
                reader = ArrayRecordReader(f)
                n = reader.num_records()
                reader.close()
                if remaining < n:
                    return f"{f}[{remaining}]"
                remaining -= n
        except Exception:  # noqa: BLE001 - only the label of an error being raised
            pass
        return f"record {index} of {self._files}"

    def read(self, index: int, use_native: bool = True) -> Tuple[np.ndarray, Optional[np.ndarray], float]:
        try:
            return decode_record(self._source[index], use_native=use_native)
        except Exception as e:
            # name the shard and its local record, so a bad shard is found
            # among thousands without bisecting the global index
            raise RuntimeError(f"failed to decode {self._locate(index)}: {e}") from e
