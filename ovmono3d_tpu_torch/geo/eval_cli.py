"""Evaluation of written GEO predictions (counterpart of
tools/eval_ovmono3d_geo.py, the reference's second GEO command).

    python -m ovmono3d_tpu_torch.geo.eval_cli --config-file configs/... \
        [--output-dir output/geo] [key=value ...]

It is `geo.cli` with `--eval` and `--eval-only` added: each dataset's
geo_predictions_<dataset>.pkl in `--output-dir` is evaluated against its
ground truth without running the models.
"""
from __future__ import annotations

import sys

from ovmono3d_tpu_torch.geo import cli


def main(argv=None) -> dict | None:
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in ("--eval", "--eval-only"):
        if flag not in argv:
            argv.append(flag)
    return cli.main(argv)


if __name__ == "__main__":
    main()
