"""Migrate reference-era LMDB datasets (tensorpack LMDBSerializer) to .pack
stores (scripts/converter/lmdb_to_pack.py):

    python -m deepclr_tpu_torch.converter.lmdb_to_pack INPUT.lmdb [OUTPUT.pack]

through the dependency-free LMDB parser of ``data/lmdb_reader.py``; the
sample dicts carry over unchanged.
"""
import argparse
import os.path as osp

from ..data.lmdb_reader import iter_reference_lmdb
from ..data.pack import PackWriter


def convert(input_file: str, output_file: str) -> int:
    n = 0
    with PackWriter(output_file) as w:
        for key, sample in iter_reference_lmdb(input_file):
            w.put(key, sample)
            n += 1
    return n


def main():
    parser = argparse.ArgumentParser(description="Convert a reference LMDB dataset into a .pack store.")
    parser.add_argument("input", type=str, help="LMDB file (single-file env)")
    parser.add_argument("output", type=str, nargs="?", default=None,
                        help="output .pack (default: input with .pack suffix)")
    args = parser.parse_args()

    output = args.output or osp.splitext(args.input)[0] + ".pack"
    n = convert(args.input, output)
    print(f"converted {n} samples -> {output}")


if __name__ == "__main__":
    main()
