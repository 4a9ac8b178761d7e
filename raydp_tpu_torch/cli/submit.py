"""``raydp-tpu-torch-submit`` — run a driver script against the port (the
port's copy of ``raydp_tpu/cli/submit.py``).

CLI parity with the reference's ``bin/raydp-submit``
(reference: bin/raydp-submit:62-69 — vendored spark-submit with
``--master ray``): sets up the environment (cluster size, memory,
placement strategy, extra configs) and executes the user's Python driver,
which calls ``raydp_tpu_torch.init()`` and runs ETL + training.

Config flows to the driver via RAYDP_TPU_* environment variables consumed
by ``init()`` defaults when explicit arguments are absent. The CLI does no
device work: the driver script chooses its device.

    python -m raydp_tpu_torch.cli.submit --num-workers 2 --conf k=v driver.py
"""
from __future__ import annotations

import argparse
import os
import runpy
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raydp-tpu-torch-submit",
        description="Run a raydp_tpu_torch driver script.",
    )
    p.add_argument("script", help="path to the Python driver script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    p.add_argument("--name", default=None, help="application name")
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--cores-per-worker", type=int, default=None)
    p.add_argument("--memory-per-worker", default=None, help='e.g. "2GB"')
    p.add_argument(
        "--placement-strategy",
        default=None,
        choices=["PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"],
    )
    p.add_argument(
        "--conf",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="extra config (repeatable)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.script):
        print(f"raydp-tpu-torch-submit: script not found: {args.script}",
              file=sys.stderr)
        return 2

    env = {
        "RAYDP_TPU_APP_NAME": args.name,
        "RAYDP_TPU_NUM_WORKERS": args.num_workers,
        "RAYDP_TPU_CORES_PER_WORKER": args.cores_per_worker,
        "RAYDP_TPU_MEMORY_PER_WORKER": args.memory_per_worker,
        "RAYDP_TPU_PLACEMENT_STRATEGY": args.placement_strategy,
    }
    for key, value in env.items():
        if value is not None:
            os.environ[key] = str(value)
    for item in args.conf:
        if "=" not in item:
            print(f"raydp-tpu-torch-submit: bad --conf {item!r}",
                  file=sys.stderr)
            return 2
        key, _, value = item.partition("=")
        os.environ[f"RAYDP_TPU_CONF_{key}"] = value

    sys.argv = [args.script] + list(args.script_args)
    runpy.run_path(args.script, run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
