"""Write a bundle for the native AOTInductor host.

Counterpart of ``tools/export_pjrt_bundle.py``. The implementation lives in
``dmlc_tpu_torch.models.aoti_bundle`` (the port CLI's `export-bundle` verb
uses it too); this script is the standalone entry point:

    python3 dmlc_tpu_torch/tools/export_aoti_bundle.py --model resnet18 \\
        --batch 8 --out /tmp/bundle [--image a.jpg ...] [--device cpu]

then, with no Python in the serving process:

    dmlc_tpu_torch/_build/aoti_host run /tmp/bundle --iters 100

(the host is built at first use by ``dmlc_tpu_torch.ops._build_host``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet18")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--image", action="append", default=None,
        help="JPEG(s) to decode into the staged input batch (repeatable); "
        "default: zeros",
    )
    ap.add_argument("--device", default=None,
                    help="device to export and compile for (default: the card)")
    args = ap.parse_args()
    # Lazy: --help must not pay the torch startup.
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from dmlc_tpu_torch.models.aoti_bundle import export_bundle

    info = export_bundle(
        args.model, args.batch, Path(args.out), seed=args.seed,
        image_paths=args.image, device=args.device,
    )
    print(info)


if __name__ == "__main__":
    main()
