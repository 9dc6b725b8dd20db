"""Convert a PNG-tree split into ArrayRecord shards.

    python -m bts_tpu_torch.tools.make_records --filenames_file train_test_inputs/... \
        --data_path /data/kitti --gt_path /data/kitti_gt \
        --out /data/records/eigen_train [--shard_size 1024]

Then train with ``--filenames_file '/data/records/eigen_train-*.array_record'``:
the loader reads records by index, with the PNG tree's epoch order,
data-parallel rows and sample-exact resume.  The counterpart of
``scripts/make_records.py``, with its flags; the shards are the same bytes.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--filenames_file", required=True)
    ap.add_argument("--data_path", default="")
    ap.add_argument("--gt_path", default="")
    ap.add_argument("--out", required=True, help="output shard prefix")
    ap.add_argument("--shard_size", type=int, default=1024)
    args = ap.parse_args(argv)

    from bts_tpu_torch.data.dataloader import parse_filenames_file
    from bts_tpu_torch.data.records import write_records

    samples = parse_filenames_file(args.filenames_file, args.data_path, args.gt_path)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    paths = write_records(samples, args.out, shard_size=args.shard_size)
    print(f"[bts_tpu_torch] wrote {len(samples)} records into {len(paths)} shards:")
    for p in paths:
        print("  " + p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
