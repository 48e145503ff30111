"""CelebAMask-HQ preprocessing entry point (port of ``cdgvae_tpu/cli/
celeba_preprocess.py``, the same flags plus ``--device``): convert the
raw corpus into per-sample [H, W, 3+5] npy files and labels
(``data/celeba.py::preprocess``), decoding on the card unless ``--device
cpu`` is given. On the card the JPEGs' entropy decoding and the mask
PNGs' row unfilter are native code (``csrc/jpeg_huffman.cpp`` and
``csrc/png_unfilter.cpp``) on host threads beside the device work, and
the pixel reconstruction and the resizes are CUDA kernels
(``csrc/jpeg_reconstruct.cu`` and ``csrc/cv_resize.cu``), all built at
first use (a failed build exits with its error); on the CPU the plain
versions.

Usage: python -m cdgvae_torch.cli.celeba_preprocess --base_dir
./CelebAMask-HQ --out_dir ./data [--causal_structure attractive]
[--img_size 64] [--test] [--device cpu]
"""
from __future__ import annotations

import argparse

from ..data.celeba import preprocess
from .common import add_device_arg


def get_args(argv=None):
    parser = argparse.ArgumentParser("parameters")
    parser.add_argument("--base_dir", type=str, default="./CelebAMask-HQ",
                        help="directory with CelebA-HQ-img/, "
                             "CelebAMask-HQ-mask-anno/, attribute anno txt")
    parser.add_argument("--out_dir", type=str, default="./data")
    parser.add_argument("--causal_structure", type=str, default="smile",
                        help="smile or attractive")
    parser.add_argument("--img_size", type=int, default=128)
    parser.add_argument("--test", action="store_true",
                        help="write the test split instead of train")
    add_device_arg(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    s = preprocess(args.base_dir, args.out_dir, args.causal_structure,
                   args.img_size, train=not args.test,
                   device=args.device)
    print(f"preprocessed {s['files']} {'test' if args.test else 'train'} "
          f"images at {args.img_size} px in {s['wall']:.3f} s, "
          f"{s['files'] / max(s['wall'], 1e-9):.2f} files/s: host threads "
          f"(JPEG entropy decoding: {s['entropy']}; PNG unfilter: "
          f"{s['unfilter']}) {s['jpeg']:.3f} s of JPEGs, {s['png']:.3f} s "
          f"of PNG masks, waited for "
          f"{s['wait']:.3f} s; device work at most "
          f"{s['device_calls']} operators and launches a chunk: "
          f"reconstruction {s['reconstruct']:.3f} s, resizes "
          f"{s['resize']:.3f} s, copy to the host {s['copy']:.3f} s; "
          f"writes {s['write']:.3f} s")
    return s


if __name__ == "__main__":
    main()
