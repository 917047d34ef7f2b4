"""One-off dataset resizer (data/resize.py mirror; a copy of
`ransacflow_tpu/cli/resize_dataset.py`, which cannot be imported without
JAX).

  python -m ransacflow_tpu_torch.cli.resize_dataset --inputDir in/ \
      --outputDir out/ --maxSize 480
"""

import argparse
import os

from PIL import Image


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--inputDir", type=str, required=True)
    parser.add_argument("--outputDir", type=str, required=True)
    parser.add_argument("--maxSize", type=int, required=True)
    args = parser.parse_args(argv)

    os.makedirs(args.outputDir, exist_ok=True)
    for i, name in enumerate(sorted(os.listdir(args.inputDir))):
        img = Image.open(os.path.join(args.inputDir, name)).convert("RGB")
        w, h = img.size
        ratio = max(w / float(args.maxSize), h / float(args.maxSize))
        resized = img.resize(
            (int(round(w / ratio)), int(round(h / ratio))),
            resample=Image.LANCZOS,
        )
        resized.save(os.path.join(args.outputDir, f"{i}.png"))


if __name__ == "__main__":
    main()
