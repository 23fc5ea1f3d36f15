"""Auto-resume supervisor: a training run survives a hung device fetch
without an operator.

Port of ``tools/run_supervised.py`` for ``graphsage_torch.cli``.  The CLI
exits with code 17 when a deadline-guarded device fetch expires
(``utils/obs.py::fetch_with_deadline``: a kernel hung on the card, and the
process cannot recover).  This supervisor relaunches the command with
``--resume <newest checkpoint>``, a bounded number of times, and writes a
jsonl event log.

    python -m graphsage_torch.supervise [--max_restarts N] [--log F] \
        [--wedge_rc 17] -- <graphsage_torch.cli args...>

    python -m graphsage_torch.supervise --max_restarts 3 -- \
        --dataSet powerlaw:2000:10000 --epochs 50 --name prod --quiet

Semantics:
- rc 0: done, the supervisor exits 0.
- rc 17 (wedge): take the newest checkpoint of this run under
  ``--checkpoint_dir`` (newest mtime; the CLI names them
  ``model_best_<name>_ep<E>_<f1>``), strip any earlier ``--resume`` and
  ``--max_vali_f1`` from the args and relaunch with ``--resume <ckpt>``.
  Without a checkpoint yet, relaunch with the original args untouched (the
  wedge came before the first val improvement).  At most
  ``--max_restarts`` relaunches, then exit 17.
- any other rc: a real error; exit with it at once (a restart cannot fix
  a crash that is not a wedge).

Resume correctness is the checkpoint layer's contract
(``utils/checkpoint.py``): params, epoch, best F1, the host RandomState
and, for the cached pipeline, the device sampler's generator state, exact
for supervised runs with ``refresh_every`` 1.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time


def _newest_checkpoint(ckpt_dir: str, run_name: str) -> str | None:
    """Newest checkpoint of this run: a shared checkpoint_dir may hold
    other runs' checkpoints, and resuming another run's params and RNG
    would silently continue the wrong model.  The whole basename must be
    the CLI's ``model_best_<name>_ep<E>_<f1>``: a prefix match would take
    run ``<name>_v2``'s checkpoints too.  The checkpoint writer's
    temporary files (``.tmp-...``) do not match."""
    if not os.path.isdir(ckpt_dir):
        return None
    pattern = re.compile(re.escape(f"model_best_{run_name}")
                         + r"_ep\d+_\d+\.\d+")
    entries = [os.path.join(ckpt_dir, e) for e in os.listdir(ckpt_dir)
               if pattern.fullmatch(e)]
    if not entries:
        return None
    return max(entries, key=os.path.getmtime)


def _strip_flag(args: list[str], flag: str) -> list[str]:
    out, skip = [], False
    for a in args:
        if skip:
            skip = False
            continue
        if a == flag:
            skip = True
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out


def _flag_value(args: list[str], flag: str, default: str | None
                ) -> str | None:
    for i, a in enumerate(args):
        if a == flag and i + 1 < len(args):
            return args[i + 1]
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return default


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        print("usage: python -m graphsage_torch.supervise [opts] -- "
              "<cli args>", file=sys.stderr)
        return 2
    split = argv.index("--")
    sup_args, cli_args = argv[:split], argv[split + 1:]
    p = argparse.ArgumentParser(prog="python -m graphsage_torch.supervise")
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--log", type=str, default=None,
                   help="jsonl supervisor event log")
    p.add_argument("--wedge_rc", type=int, default=17,
                   help="exit code that means 'wedged, restart and resume'")
    opts = p.parse_args(sup_args)

    t0 = time.time()
    fp = open(opts.log, "a") if opts.log else None

    def log(event: str, **fields):
        rec = {"t": round(time.time() - t0, 3), "event": event, **fields}
        line = json.dumps(rec)
        if fp:
            fp.write(line + "\n")
            fp.flush()
        print(f"[supervisor] {line}", file=sys.stderr, flush=True)

    ckpt_dir = _flag_value(cli_args, "--checkpoint_dir", "checkpoints")
    run_name = _flag_value(cli_args, "--name", "debug")
    attempt = 0
    args = cli_args
    try:
        while True:
            cmd = [sys.executable, "-u", "-m", "graphsage_torch.cli"] + args
            log("launch", attempt=attempt, cmd=cmd)
            rc = subprocess.call(cmd)
            log("exit", attempt=attempt, rc=rc)
            if rc != opts.wedge_rc:
                # a clean finish or a real (non-wedge) failure: restarting
                # is wrong either way; surface the child's code
                return rc
            if attempt >= opts.max_restarts:
                log("giving_up", restarts=attempt)
                return rc
            attempt += 1
            ckpt = _newest_checkpoint(ckpt_dir, run_name)
            if ckpt is not None:
                args = _strip_flag(_strip_flag(cli_args, "--resume"),
                                   "--max_vali_f1") + ["--resume", ckpt]
                log("restart", attempt=attempt, resume=ckpt)
            else:
                # wedged before this run wrote its first checkpoint:
                # relaunch with the original args untouched (stripping an
                # operator's own --resume would restart their run from
                # scratch)
                args = cli_args
                log("restart", attempt=attempt,
                    resume=_flag_value(cli_args, "--resume", None))
    finally:
        if fp:
            fp.close()


if __name__ == "__main__":
    sys.exit(main())
