"""The benchmark's command: one run of one cell.

    python3 -m clbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
run's result, one JSON object; the last lines of standard error are the
check's numbers, each beside its limit. The run exits with another code
than 0, and prints no result, where the card or the program is missing,
or where the process has loaded JAX or the JAX package."""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from clbench.spec import REPO_DIR  # noqa: E402

# caches of kernels the process may build, at fixed paths in the checkout
CACHE_DIR = os.path.join(REPO_DIR, ".clbench_cache")


def environment() -> None:
    """Fixed cache directories inside the checkout, and the program's
    defaults: no environment setting of the program's changes the work."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    for var in [v for v in os.environ if v.startswith("CLSURVEY_")]:
        del os.environ[var]


def _fail(code: int, msg: str) -> int:
    print(f"clbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m clbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    environment()

    from clbench.spec import Spec

    spec = Spec()
    try:
        cell = spec.cell(args.workload)
    except KeyError as e:
        return _fail(2, str(e))
    import torch

    if not torch.cuda.is_available():
        return _fail(3, "no CUDA card (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < int(cell["chips"]):
        return _fail(3, f"{args.workload} needs {cell['chips']} cards, "
                        f"{torch.cuda.device_count()} present")
    try:
        import clsurvey_torch  # noqa: F401
    except ImportError as e:
        return _fail(4, f"the program clsurvey_torch is missing: {e}")

    from clbench import harness

    result, lines = harness.run(
        spec, args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", t_start=T_START,
        log=lambda msg: print(msg, file=sys.stderr, flush=True))
    banned = harness.banned_modules()
    if banned:
        return _fail(5, "the process loaded " + ", ".join(banned))
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
