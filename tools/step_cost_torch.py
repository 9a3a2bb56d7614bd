"""What the flags of a ``train_torch.py`` run cost its gpt_lm step on the
card: the median step ms of ``train_torch.main`` at full width (768 wide,
12 layers, B 8 x S 2048, remat, fused head; the argv of
``chip_smoke.py``'s train phases) under a few flag sets, run by one
checkout's ``train_torch``.

    python3 tools/step_cost_torch.py [--repo DIR] [--steps 12]
        [--variants service,logged,...] [--out FILE]

``--repo`` names the checkout whose ``train_torch`` runs (default: the
one holding this script), so that two commits compare in one call on one
card: run it for each, in the order parent, change, change, parent.  A
flag set that the checkout's ``train_torch`` does not take is reported as
skipped.  ``--variants`` picks the sets and their order (a set may
come twice): every run of one process shares the process's metric
registry, so a later run's records also carry the series an earlier one
registered, and each row gives the registry's size, the fields of its
run's last record, the bytes of each file its logdir holds and the
threads alive after it.  Each set trains ``--steps`` steps from the same seed; its
median is over the records after the first (the first step autotunes and
warms the allocator), each record's ``step_ms`` the Trainer's wall time a
step since the previous log boundary (its ``t_step``).  Prints one JSON line a set, then
the card's name and power limit, then a JSON summary as the last line;
``--out`` writes the summary there too.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

#: name -> the flags added to the train phases' gpt_lm argv.  ``service``
#: is ``chip_smoke.py``'s dataservice (a) run; ``logged`` its in-process
#: feed; the others take one flag away at a time.
VARIANTS = {
    "service": ["--log-every", "1", "--logdir", "{logdir}",
                "--adaptive-prefetch", "--data-service", "2"],
    "logged": ["--log-every", "1", "--logdir", "{logdir}",
               "--adaptive-prefetch"],
    "logged_fixed_depth": ["--log-every", "1", "--logdir", "{logdir}"],
    "every_step": ["--log-every", "1"],
    "every_4": ["--log-every", "4"],
}


def _logdir_facts(logdir) -> dict:
    """The fields of the run's last metrics record and the bytes of each
    file it wrote."""
    path = os.path.join(logdir, "metrics.jsonl")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return {"record_fields": len(rows[-1]) if rows else None,
            "file_bytes": {n: os.path.getsize(os.path.join(logdir, n))
                           for n in sorted(os.listdir(logdir))
                           if os.path.isfile(os.path.join(logdir, n))}}


def _run(train_torch, torch, argv, logdir):
    """``(step ms of each record after the first, seconds)`` of one run, or
    None when its flags are not taken (argparse exits 2)."""
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            records = train_torch.main(
                [a.format(logdir=logdir) for a in argv])
    except SystemExit as e:
        if e.code == 2:
            return None
        raise
    torch.cuda.synchronize()
    return [r["step_ms"] for r in records[1:]], time.time() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repo", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--variants", default=",".join(VARIANTS),
                   help="comma-separated sets of VARIANTS, in order")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("step_cost_torch: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    os.chdir(repo)
    import train_torch
    from distributedtensorflow_tpu_torch import obs

    base = ["--workload", "gpt_lm", "--batch-size", "8", "--seq-len",
            "2048", "--remat", "on", "--seed", "0", "--device", "cuda",
            "--steps", str(args.steps)]
    out = {"repo": repo, "steps": args.steps, "runs": []}
    for name in args.variants.split(","):
        flags = VARIANTS[name]
        with tempfile.TemporaryDirectory(prefix="step_cost_") as logdir:
            got = _run(train_torch, torch, [*base, *flags], logdir)
            facts = _logdir_facts(logdir)
        row = {"variant": name, "flags": flags}
        if got is None:
            row["skipped"] = "flags not taken by this checkout"
        else:
            ms, seconds = got
            row.update(step_ms=ms, step_ms_median=statistics.median(ms),
                       seconds=seconds, **facts,
                       registry_scalars=len(
                           obs.default_registry().scalars()),
                       threads_after=sorted(
                           t.name for t in threading.enumerate()))
        out["runs"].append(row)
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out["card"] = card.strip()
    print(out["card"])
    line = json.dumps({"repo": repo, "step_ms_median": [
        [r["variant"], r.get("step_ms_median")] for r in out["runs"]]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
