"""Stall watchdog for long training runs: launch, monitor, restart on a
hang.

The port's ``Trainer`` touches ``<logs_dir>/heartbeat`` as its host loop
runs (``train/engine.py``, ``utils/heartbeat.py``), so a stale heartbeat
means the run is stuck; the watchdog kills the process group and launches
the identical command again, and ``cli train`` resumes from the newest
full-state checkpoint.

    python -m season_nerf_torch.tools.watchdog_train --logs_dir <dir> \\
        [--stall_sec 900] [--max_restarts 8] [--grace_sec 1800] -- \\
        python -m season_nerf_torch.cli train ...

The exit code is the last child's (0 on normal completion).  The
counterpart of ``tools/watchdog_train.py``, with its flags.
"""

import argparse
import os
import signal
import subprocess
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--logs_dir", required=True,
                   help="directory the trainer writes heartbeat into")
    p.add_argument("--stall_sec", type=int, default=900,
                   help="heartbeat age that counts as a stall")
    p.add_argument("--grace_sec", type=int, default=1800,
                   help="start-up allowance before the first heartbeat "
                        "(site preparation, the kernels' first build)")
    p.add_argument("--max_restarts", type=int, default=8)
    p.add_argument("--poll_sec", type=int, default=30)
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- followed by the training command")
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        p.error("no training command given (append: -- python -m "
                "season_nerf_torch.cli train ...)")

    hb = os.path.join(args.logs_dir, "heartbeat")
    restarts = 0
    while True:
        start = time.time()
        # a fresh process group, so that a stuck child and its children
        # can be killed together
        child = subprocess.Popen(cmd, start_new_session=True)
        print(f"[watchdog] launched pid {child.pid} "
              f"(restart {restarts}/{args.max_restarts})", flush=True)
        stalled = False
        while True:
            try:
                rc = child.wait(timeout=args.poll_sec)
                break
            except subprocess.TimeoutExpired:
                pass
            try:
                mt = os.path.getmtime(hb)
            except OSError:
                mt = None
            if mt is not None and mt > start:    # this incarnation beat
                waited, limit = time.time() - mt, args.stall_sec
            else:                                # still starting up
                waited, limit = time.time() - start, args.grace_sec
            if waited > limit:
                print(f"[watchdog] stall: no heartbeat for {int(waited)}s "
                      f"(limit {limit}s); killing pid {child.pid}",
                      flush=True)
                os.killpg(child.pid, signal.SIGTERM)
                try:
                    child.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    os.killpg(child.pid, signal.SIGKILL)
                    child.wait()
                rc, stalled = None, True
                break
        if not stalled:
            if rc == 0:
                print("[watchdog] run completed", flush=True)
                return 0
            print(f"[watchdog] child exited rc={rc}", flush=True)
        restarts += 1
        if restarts > args.max_restarts:
            print("[watchdog] restart budget exhausted", flush=True)
            return rc if rc is not None else 75
        time.sleep(10)    # give a wedged device a moment to recover


if __name__ == "__main__":
    sys.exit(main())
