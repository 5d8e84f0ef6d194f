"""Filelist generation (counterpart of ``audiotokenization_tpu/cli/preprocess.py``).

Walks the LibriSpeech subset directories under ``--root`` for audio files
and writes one filelist per group, one path a line (absolute, or relative
to ``--root`` with ``--relative``), as ``cli/train.py`` reads them:

- ``train_all``: train-clean-100, train-clean-360, train-other-500;
- ``dev_all``: dev-clean, dev-other;
- ``test_clean``: test-clean.

    python -m audiotokenization_tpu_torch.cli.preprocess --root data/LibriSpeech \\
        --out_dir filelists [--ext_audio .flac] [--relative] [--groups test_clean]
"""
from __future__ import annotations

import argparse
from pathlib import Path

GROUPS = {
    "train_all": ["train-clean-100", "train-clean-360", "train-other-500"],
    "dev_all": ["dev-clean", "dev-other"],
    "test_clean": ["test-clean"],
}


def find_files(root: Path, subsets, ext: str, relative: bool):
    out = []
    for subset in subsets:
        base = root / subset
        if not base.exists():
            print(f"warning: missing subset {base}")
            continue
        for f in sorted(base.rglob(f"*{ext}")):
            out.append(str(f.relative_to(root)) if relative else str(f))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", type=str, required=True,
                   help="LibriSpeech root holding the subset directories")
    p.add_argument("--out_dir", type=str, default="filelists")
    p.add_argument("--ext_audio", type=str, default=".flac")
    p.add_argument("--relative", action="store_true")
    p.add_argument("--groups", type=str, nargs="*", default=list(GROUPS),
                   help=f"the groups to write (default all: {list(GROUPS)})")
    p.add_argument("--prefix", type=str, default="librispeech")
    args = p.parse_args(argv)

    root = Path(args.root)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for group in args.groups:
        files = find_files(root, GROUPS[group], args.ext_audio, args.relative)
        path = out_dir / f"{args.prefix}_{group}.txt"
        path.write_text("\n".join(files) + ("\n" if files else ""))
        print(f"{path}: {len(files)} files")


if __name__ == "__main__":
    main()
