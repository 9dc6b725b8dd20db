"""Host-side data loading: split files -> decoded, geometry-fixed batches.

Counterpart of ``bts_tpu/data/dataloader.py`` (the PNG-tree path).  The host
only decodes PNGs and applies the fixed-geometry crops; the stochastic
augmentation runs on the card (``data/augment.py``).  Split files use the
reference format, one sample per line,

    <image_path> <depth_path> [<focal>]

paths relative to ``data_path`` / ``gt_path`` (absolute paths also work).
A missing depth is spelled ``None`` in test-mode files.

Modes: 'train' (seeded per-epoch shuffle, repeat, uint8 batches for the
augmentation) and 'test' (images only); online eval decodes its split with
:func:`load_sample` (``cli/bts_main.py::online_eval``).

Three inputs, as in the reference package:
- the PNG tree through PIL, with a Python prefetch thread;
- the PNG tree through the native C++ loader (``data/native_loader.py``:
  libpng/libjpeg decode, the crop fused into the row copy, whole batches
  assembled by C++ threads), which ``--use_native_loader auto`` takes when
  its library builds and ``always`` requires;
- ArrayRecord shards (``data/records.py``), train mode only: a
  ``--filenames_file`` ending in ``.array_record`` (a path or a glob).
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
from PIL import Image

from bts_tpu_torch.data import native_loader as nl
from bts_tpu_torch.data.crops import kb_crop, nyu_border_crop
from bts_tpu_torch.data.depth_io import depth_from_png
from bts_tpu_torch.data.records import RecordSource, looks_like_records
from bts_tpu_torch.parallel import distributed as parallel


@dataclass
class Sample:
    image_path: str
    depth_path: Optional[str]
    focal: float


def parse_filenames_file(path: str, data_path: str = "", gt_path: str = "", use_right: bool = False) -> List[Sample]:
    """Parse a reference-format split file into Samples.

    ``use_right`` swaps image_02 -> image_03 (right KITTI camera).  A line
    whose first character is ``#`` is skipped (the in-repo stub split files
    carry a provenance banner); no reference split line starts with ``#``.
    """
    samples = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if not parts:
                continue
            img = parts[0]
            depth = parts[1] if len(parts) > 1 and parts[1] != "None" else None
            focal = float(parts[2]) if len(parts) > 2 else 0.0
            if use_right:
                img = img.replace("image_02", "image_03")
                if depth:
                    depth = depth.replace("image_02", "image_03")
            samples.append(
                Sample(
                    image_path=os.path.join(data_path, img) if data_path else img,
                    depth_path=(os.path.join(gt_path, depth) if gt_path else depth) if depth else None,
                    focal=focal,
                )
            )
    return samples


def apply_fixed_geometry(
    image: np.ndarray,
    depth: Optional[np.ndarray],
    dataset: str,
    do_kb_crop: bool,
    border_crop: bool,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The fixed-geometry crops.  ``border_crop`` (NYU) is train-only in the
    reference: test/eval forward the full 480x640 frame."""
    if dataset == "nyu":
        if border_crop:
            image = nyu_border_crop(image)
            if depth is not None:
                depth = nyu_border_crop(depth)
    elif do_kb_crop:
        image = kb_crop(image)
        if depth is not None:
            depth = kb_crop(depth)
    return image, depth


def load_sample(
    sample: Sample,
    dataset: str,
    do_kb_crop: bool,
    need_depth: bool = True,
    border_crop: bool = True,
) -> Tuple[np.ndarray, Optional[np.ndarray], float]:
    """Decode one sample and apply the fixed-geometry crops.

    Returns (uint8 HWC image, float32 HW depth-in-meters or None, focal).
    """
    image = np.asarray(Image.open(sample.image_path).convert("RGB"), dtype=np.uint8)
    depth = None
    if need_depth and sample.depth_path is not None:
        depth = depth_from_png(np.array(Image.open(sample.depth_path)), dataset)
    image, depth = apply_fixed_geometry(image, depth, dataset, do_kb_crop, border_crop)
    return image, depth, sample.focal


class BtsDataLoader:
    """Batch iterator over a split file (reference ``BtsDataloader``).

    Yields dict batches of host numpy arrays:
        image: (B, H, W, 3) uint8
        depth: (B, H, W) float32 meters  (absent in test mode)
        focal: (B,) float32
    """

    def __init__(self, cfg, mode: str):
        self.cfg = cfg
        self.mode = mode
        if mode not in ("train", "test"):
            raise ValueError(f"mode must be 'train' or 'test', got {mode!r}")
        fn, dp, gp = cfg.filenames_file, cfg.data_path, cfg.gt_path
        self.use_right = bool(cfg.use_right) and mode == "train"
        self.record_source = None
        if fn and looks_like_records(fn):
            if mode != "train":
                raise ValueError(
                    "ArrayRecord input is a training path; test/eval drivers "
                    "need per-sample file paths (prediction naming, gt lookup) "
                    "— point them at a PNG-tree split file"
                )
            if self.use_right:
                raise ValueError(
                    "--use_right needs the PNG-tree loader: records bake one "
                    "camera per sample (write both views into the shards instead)"
                )
            self.record_source = RecordSource(fn)
            self.samples = []
            self.n_base = len(self.record_source)
        else:
            self.samples = parse_filenames_file(fn, dp, gp)
            self.n_base = len(self.samples)
            # reference --use_right: the right camera is chosen per sample per
            # epoch; left in [0, n), right in [n, 2n)
            if self.use_right:
                self.samples = self.samples + parse_filenames_file(fn, dp, gp, use_right=True)
        self.batch_size = cfg.batch_size
        if mode == "train" and self.n_base < self.batch_size:
            raise ValueError(
                f"{self.n_base} train samples < batch_size {self.batch_size}: "
                "every epoch would be empty (train mode drops the remainder)"
            )
        # data parallel: every rank shuffles with the same seed (one global
        # order) and loads its data group's share of each global microbatch
        # (the bands of one frame are one data group: the same rows)
        self.rows = None
        if mode == "train" and parallel.data_world() > 1:
            self.rows = parallel.rank_rows(self.batch_size, max(1, int(cfg.grad_accum_steps)),
                                           parallel.data_rank(), parallel.data_world())
        self.local_batch = self.batch_size if self.rows is None else len(self.rows)

    def __len__(self):
        return self.n_base

    def steps_per_epoch(self) -> int:
        return max(1, self.n_base // self.batch_size)

    def _load_index(self, i: int):
        if self.record_source is not None:
            return self._load_record(i)
        need_depth = self.mode != "test"
        img, depth, focal = load_sample(
            self.samples[i],
            self.cfg.dataset,
            self.cfg.do_kb_crop,
            need_depth,
            border_crop=self.mode == "train",
        )
        if depth is None and need_depth:
            depth = np.zeros(img.shape[:2], np.float32)
        return img, depth, focal

    def _load_record(self, index: int):
        """Decode record ``index`` to the contract of :meth:`_load_index`."""
        img, raw_depth, focal = self.record_source.read(index, use_native=self.cfg.use_native_loader != "never")
        depth = depth_from_png(raw_depth, self.cfg.dataset) if raw_depth is not None else None
        img, depth = apply_fixed_geometry(img, depth, self.cfg.dataset, self.cfg.do_kb_crop, border_crop=True)
        if depth is None:
            depth = np.zeros(img.shape[:2], np.float32)
        return img, depth, focal

    def _epoch_order(self, epoch: int = 0) -> List[int]:
        """Sample order for one epoch, a pure function of (seed, epoch), so a
        resumed run recomputes epoch e's order without replaying the others."""
        idx = np.arange(self.n_base)
        if self.mode == "train":
            rng = np.random.default_rng([self.cfg.seed, epoch])
            rng.shuffle(idx)
            if self.use_right:
                idx = idx + self.n_base * rng.integers(0, 2, size=idx.shape)
        return list(idx)

    def batches(self, num_epochs: Optional[int] = None, start_step: int = 0) -> Iterator[dict]:
        """Yield batches; infinite when num_epochs is None and mode=='train'.

        ``start_step`` (train mode): resume the global-step sequence exactly
        there — same epoch order, same position within the epoch.
        """
        spe = self.steps_per_epoch()
        epoch = start_step // spe if self.mode == "train" else 0
        skip = start_step % spe if self.mode == "train" else 0
        done = 0
        pool = None
        if self.cfg.dataloader_workers > 1 and self.local_batch > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(self.cfg.dataloader_workers)
        try:
            while num_epochs is None or done < num_epochs:
                order = self._epoch_order(epoch)
                # train drops the remainder; test pads it with the last
                # sample (consumers write only the first len(self) results)
                rem = len(order) % self.batch_size
                if rem and self.mode == "train":
                    order = order[: len(order) - rem]
                elif rem:
                    order = order + [order[-1]] * (self.batch_size - rem)
                for start in range(skip * self.batch_size, len(order), self.batch_size):
                    chunk = order[start : start + self.batch_size]
                    if self.rows is not None:
                        chunk = [chunk[r] for r in self.rows]
                    if pool is not None:
                        loaded = list(pool.map(self._load_index, chunk))
                    else:
                        loaded = [self._load_index(i) for i in chunk]
                    batch = {
                        "image": np.stack([x[0] for x in loaded]),
                        "focal": np.array([x[2] for x in loaded], np.float32),
                    }
                    if self.mode != "test":
                        batch["depth"] = np.stack([x[1] for x in loaded])
                    yield batch
                skip = 0
                epoch += 1
                done += 1
                if self.mode != "train":
                    break
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def _crop_mode(self) -> int:
        if self.cfg.dataset == "nyu":
            return nl.CROP_NYU if self.mode == "train" else nl.CROP_NONE
        return nl.CROP_KB if self.cfg.do_kb_crop else nl.CROP_NONE

    def _native(self, num_epochs: Optional[int], start_step: int = 0) -> Tuple[Optional[Iterator[dict]], str]:
        """The C++ decode-and-prefetch stream (``csrc/btsdata.cc``) and the
        line that names it; or None and the line that says which path is
        taken instead, and why."""
        choice = self.cfg.use_native_loader
        if choice != "never" and not nl.available():
            if choice == "always":
                raise RuntimeError(f"--use_native_loader always, but {nl.unavailable_reason()}")
            why = f"the native loader did not build: {nl.unavailable_reason()}"
        else:
            why = "--use_native_loader never" if choice == "never" else ""
        if self.record_source is not None:  # records are decoded by _load_record
            return None, f"ArrayRecord shards, {f'PIL decode ({why})' if why else 'native in-memory decode'}"
        if why:
            return None, f"PIL ({why})"
        crop_mode = self._crop_mode()
        if crop_mode == nl.CROP_NONE:
            if self.cfg.dataset == "kitti":
                # raw KITTI frames differ in size between drives: without the
                # KB crop there is no one geometry to assemble a batch in
                return None, "PIL (KITTI frames without --do_kb_crop differ in size)"
            # one geometry across the split: sample 0's
            w, h = Image.open(self.samples[0].image_path).size
        else:
            h, w = nl.crop_shape(crop_mode, 0, 0)
        loader = nl.NativeBatchLoader(
            [s.image_path for s in self.samples],
            [s.depth_path for s in self.samples],
            [s.focal for s in self.samples],
            batch=self.local_batch,
            height=h,
            width=w,
            crop_mode=crop_mode,
            inv_scale=1.0 / (1000.0 if self.cfg.dataset == "nyu" else 256.0),
            with_depth=self.mode != "test",
            num_threads=max(self.cfg.dataloader_workers, self.cfg.num_threads),
        )

        def gen():
            try:
                spe = self.steps_per_epoch()
                epoch = start_step // spe if self.mode == "train" else 0
                skip = start_step % spe if self.mode == "train" else 0
                done = 0
                while num_epochs is None or done < num_epochs:
                    order = np.asarray(self._epoch_order(epoch), np.int32)
                    if self.mode == "train":
                        usable = len(order) - (len(order) % self.batch_size)
                        order = order[:usable].reshape(-1, self.batch_size)
                        if self.rows is not None:
                            order = order[:, self.rows]  # this rank's rows of each global batch
                        # mid-epoch resume: drop the batches already consumed
                        order = order[skip:].reshape(-1)
                    elif len(order) % self.batch_size:
                        # test mode pads the tail batch with its last sample
                        pad = self.batch_size - len(order) % self.batch_size
                        order = np.concatenate([order, np.repeat(order[-1:], pad)])
                    loader.start_epoch(order)
                    yield from loader
                    skip = 0
                    epoch += 1
                    done += 1
                    if self.mode != "train":
                        break
            finally:
                loader.close()  # stops and joins the C++ workers

        what = {nl.CROP_KB: "KB crop", nl.CROP_NYU: "NYU border crop", nl.CROP_NONE: f"{h}x{w}"}[crop_mode]
        return gen(), f"native C++ loader ({what}, {loader.num_threads} threads)"

    def prefetched(
        self, num_epochs: Optional[int] = None, depth: int = 2, start_step: int = 0
    ) -> Iterator[dict]:
        """Batches decoded ahead of the consumer: by the native C++ loader
        when it is usable, else by PIL on a background thread.  Prints one
        line naming the path taken (and why, for PIL).  ``start_step``
        resumes the train-mode sequence sample-exactly on either path.
        Closing the stream stops its threads."""
        native, line = self._native(num_epochs, start_step)
        if parallel.is_primary():
            print(f"[bts_tpu_torch] input: {line}", flush=True)
        if native is not None:
            return native
        return self._py_prefetched(num_epochs, depth, start_step)

    def _py_prefetched(
        self, num_epochs: Optional[int] = None, depth: int = 2, start_step: int = 0
    ) -> Iterator[dict]:
        """PIL decode (or records) on a background thread ahead of the consumer.

        Closing (or abandoning) this generator stops the worker and closes
        the underlying :meth:`batches` generator, so its decode pool shuts
        down when an infinite train stream is dropped mid-epoch.  A loader
        failure is re-raised on the consumer side.
        """
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        sentinel = object()
        stop = threading.Event()

        def guarded_put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            gen = self.batches(num_epochs, start_step)
            try:
                for b in gen:
                    if not guarded_put(b):
                        return
                guarded_put(sentinel)
            except BaseException as e:  # noqa: BLE001 - re-raised on the consumer side
                guarded_put(e)
            finally:
                gen.close()

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
