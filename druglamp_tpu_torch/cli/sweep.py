"""5-seed sweep driver with restart-on-failure, over the port's training CLI
(the port's copy of ``druglamp_tpu.cli.sweep``, pointed at
``druglamp_tpu_torch.cli.main``).

Seeds 40–44 run one after another, each retried until it succeeds (the
reference's per-(dataset, split, model) scripts wrap every seed in an
infinite retry loop); embedding caches persist, so a restart is cheap.  The
driver records each seed's exit code in a summary JSON.

    python -m druglamp_tpu_torch.cli.sweep --model DrugLAMP --data human --split random \
        -- --device cuda --data-root datasets
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CLI_MODULE = "druglamp_tpu_torch.cli.main"


def _run_seed(cmd, watchdog: int, grace: int = 0, log_dir: str = "logs/sweep") -> int:
    """Run one seed subprocess; with watchdog > 0, kill it (rc 124) when its
    combined output is quiet for ``watchdog`` seconds.

    Before the FIRST byte of output the threshold is ``grace`` (default
    4×watchdog, floor 30 min): process start-up and the first epoch's kernel
    builds are legitimately silent far longer than a steady-state epoch gap.
    The child's log persists under ``log_dir`` on failure and is deleted
    only on success."""
    if watchdog <= 0:
        return subprocess.call(cmd)
    grace = grace if grace > 0 else max(4 * watchdog, 1800)
    os.makedirs(log_dir, exist_ok=True)
    log_path = os.path.join(log_dir, f"seed_{time.strftime('%m%d_%H%M%S')}_{os.getpid()}.log")
    rc = None
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=log)
        try:
            poll = min(30, max(1, watchdog // 4))
            while rc is None:
                try:
                    rc = proc.wait(timeout=poll)
                except subprocess.TimeoutExpired:
                    quiet = time.time() - os.path.getmtime(log_path)
                    started = os.path.getsize(log_path) > 0
                    if quiet > (watchdog if started else grace):
                        print(f"[sweep] WATCHDOG: output quiet {quiet:.0f}s "
                              f"({'running' if started else 'startup'}); "
                              f"killing pid {proc.pid}", file=sys.stderr, flush=True)
                        proc.terminate()
                        try:
                            proc.wait(timeout=10)
                        except subprocess.TimeoutExpired:
                            proc.kill()
                            proc.wait()
                        rc = 124
        finally:
            if rc is None:       # exception path: don't leak the child
                proc.kill()
                proc.wait()
            sys.stderr.write(_tail(log_path))
            if rc == 0:
                os.unlink(log_path)
            else:
                print(f"[sweep] child log kept at {log_path}", file=sys.stderr, flush=True)
    return rc


def _tail(path: str, n: int = 20) -> str:
    try:
        with open(path, "r", errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return ""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="DrugLAMP (PyTorch) 5-seed sweep")
    p.add_argument("--model", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--split", default="random")
    p.add_argument("--seeds", type=int, nargs="+", default=[40, 41, 42, 43, 44])
    p.add_argument("--max-retries", type=int, default=0,
                   help="0 = retry forever (reference behaviour)")
    p.add_argument("--in-process", action="store_true",
                   help="run seeds in this process (shares the built kernels and "
                        "the card's context); a failing seed falls back to the "
                        "subprocess retry loop")
    p.add_argument("--watchdog", type=int, default=0, metavar="SECONDS",
                   help="stall detector for subprocess seeds: kill and retry "
                        "a run whose output goes quiet this long")
    p.add_argument("--watchdog-grace", type=int, default=0, metavar="SECONDS",
                   help="quiet threshold before the first output byte "
                        "(start-up, kernel builds); default max(4×watchdog, 30 min)")
    p.add_argument("--out", type=str, default=None, help="summary JSON path")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="extra flags forwarded to the CLI (prefix with --)")
    args = p.parse_args(argv)

    extra = [a for a in args.rest if a != "--"]
    results = {}
    for seed in args.seeds:
        argv = ["--model", args.model, "--data", args.data,
                "--split", args.split, "--seed", str(seed)] + extra
        cmd = [sys.executable, "-m", CLI_MODULE] + argv
        if args.in_process:
            from druglamp_tpu_torch.cli import main as cli_main

            print(f"[sweep] seed {seed} (in-process): {' '.join(argv)}",
                  file=sys.stderr, flush=True)
            try:
                rc = cli_main.main(argv)
            except Exception as e:
                print(f"[sweep] seed {seed} in-process failed ({e!r}); "
                      f"falling back to subprocess", file=sys.stderr, flush=True)
                rc = 1
            if rc == 0:
                results[seed] = 0
                continue
        attempt = 0
        while True:
            attempt += 1
            print(f"[sweep] seed {seed} attempt {attempt}: {' '.join(cmd)}",
                  file=sys.stderr, flush=True)
            rc = _run_seed(cmd, args.watchdog, grace=args.watchdog_grace)
            if rc == 0:
                break
            print(f"[sweep] seed {seed} failed (rc={rc}); restarting...",
                  file=sys.stderr, flush=True)
            if args.max_retries and attempt >= args.max_retries:
                print(f"[sweep] seed {seed} giving up after {attempt} attempts",
                      file=sys.stderr)
                break
            time.sleep(2)
        results[seed] = rc

    summary = {"model": args.model, "data": args.data, "split": args.split,
               "exit_codes": results}
    out = args.out or f"sweep_{args.data}_{args.split}_{args.model}.json"
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0 if all(rc == 0 for rc in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
