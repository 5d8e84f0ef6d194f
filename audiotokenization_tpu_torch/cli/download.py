"""Dataset downloader CLI (counterpart of
``audiotokenization_tpu/cli/download.py``; the reference's download.py).

Fetches the OpenSLR archives of LibriSpeech or LibriTTS subsets and
extracts them under ``--root``; an archive already in ``--root`` is not
fetched again. It needs network access; on a machine without it, point the
filelists at a corpus already on disk (``cli/preprocess.py``).

    python -m audiotokenization_tpu_torch.cli.download --dataset librispeech \
        --subsets test-clean dev-clean --root data/LibriSpeech
"""
from __future__ import annotations

import argparse
import tarfile
import urllib.request
from pathlib import Path

LIBRISPEECH_URL = "https://www.openslr.org/resources/12/{subset}.tar.gz"
LIBRITTS_URL = "https://www.openslr.org/resources/60/{subset}.tar.gz"

SUBSETS = {
    "librispeech": ["train-clean-100", "train-clean-360", "train-other-500",
                    "dev-clean", "dev-other", "test-clean", "test-other"],
    "libritts": ["train-clean-100", "train-clean-360", "train-other-500",
                 "dev-clean", "dev-other", "test-clean", "test-other"],
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=["librispeech", "libritts"], default="librispeech")
    p.add_argument("--subsets", nargs="+", default=["test-clean"])
    p.add_argument("--root", type=str, required=True)
    args = p.parse_args(argv)

    root = Path(args.root)
    root.mkdir(parents=True, exist_ok=True)
    url_tpl = LIBRISPEECH_URL if args.dataset == "librispeech" else LIBRITTS_URL
    for subset in args.subsets:
        if subset not in SUBSETS[args.dataset]:
            raise SystemExit(f"unknown subset {subset}")
        url = url_tpl.format(subset=subset)
        tar_path = root / f"{subset}.tar.gz"
        if not tar_path.exists():
            print(f"downloading {url} ...")
            urllib.request.urlretrieve(url, tar_path)
        print(f"extracting {tar_path} ...")
        with tarfile.open(tar_path) as tf:
            tf.extractall(root, filter="data")  # no member may land outside root
        print(f"done: {subset}")


if __name__ == "__main__":
    main()
