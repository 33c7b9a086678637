"""trac — the main simulation driver CLI.

Usage mirrors the reference (``/root/reference/src/trac.c:78``):

    python -m mptrac_tpu.tools.trac <dirlist> <ctl> <atm_in> [KEY VALUE ...]

Each line of <dirlist> names a working directory containing the control
and particle files; tasks run sequentially (the reference distributes
them over MPI ranks — here use a job array or multiple processes).
"""

from __future__ import annotations

import os
import sys

from mptrac_tpu.tools._cli import require_args, run_tool


def worker_cards(workers: int):
    """Card for each of ``workers`` local worker processes: one GPU
    each, as many workers as visible GPUs at most, since every JAX
    process reserves most of its card's memory.  ``None`` entries
    (no GPU visible, or JAX_PLATFORMS=cpu) leave the device to JAX.

    Read without starting JAX, so the parent holds no card."""
    import subprocess
    if os.environ.get("JAX_PLATFORMS", "").split(",")[0] == "cpu":
        return [None] * workers
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        cards = [c.strip() for c in env.split(",") if c.strip()]
    else:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=index",
                 "--format=csv,noheader"], capture_output=True,
                text=True, timeout=60, check=True).stdout
        except (OSError, subprocess.SubprocessError):
            return [None] * workers
        cards = out.split()
    return cards[:workers] if cards else [None] * workers


def main(argv):
    require_args(argv, 4, "trac <dirlist> <ctl> <atm_in> [KEY VALUE ...]")
    from mptrac_tpu.sim import run_trac
    with open(argv[1]) as f:
        dirnames = [line.strip() for line in f if line.strip()]
    # Ensemble task farm (reference trac.c:86-94 distributes dirlist
    # tasks rank-strided over MPI): set MPTRAC_NTASK/MPTRAC_RANK for a
    # job array, or MPTRAC_WORKERS for a local process pool.
    ntask = int(os.environ.get("MPTRAC_NTASK", "1"))
    rank = int(os.environ.get("MPTRAC_RANK", "0"))
    mine = dirnames[rank::ntask] if ntask > 1 else dirnames
    workers = int(os.environ.get("MPTRAC_WORKERS", "0"))
    if workers > 1 and len(mine) > 1:
        return _run_pool(mine, argv, worker_cards(workers))
    for dirname in mine:
        run_trac(dirname, argv[2], argv[3], argv[4:])
    return 0


def _run_pool(dirnames, argv, cards):
    """One child process per task, at most one per entry of
    ``cards`` at a time; each child gets its entry's card."""
    import subprocess
    import time
    free = list(cards)
    running = {}
    rcs = []
    for dirname in dirnames:
        while not free:
            for p in [p for p in running if p.poll() is not None]:
                free.append(running.pop(p))
                rcs.append(p.returncode)
            if not free:
                time.sleep(0.2)
        card = free.pop(0)
        env = dict(os.environ, MPTRAC_WORKERS="0")
        if card is not None:
            env["CUDA_VISIBLE_DEVICES"] = card
        with open(os.path.join(dirname, "trac.log"), "w") as log:
            p = subprocess.Popen(
                [sys.executable, "-m", "mptrac_tpu.tools.trac",
                 "/dev/stdin", argv[2], argv[3], *argv[4:]],
                stdin=subprocess.PIPE, stdout=log, stderr=log,
                env=env, text=True)
        p.stdin.write(dirname + "\n")
        p.stdin.close()
        running[p] = card
    rcs += [p.wait() for p in running]
    return max(rcs) if rcs else 0


if __name__ == "__main__":
    from mptrac_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    sys.exit(run_tool(main))
