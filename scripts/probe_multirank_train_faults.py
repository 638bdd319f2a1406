#!/usr/bin/env python3
"""What the gates of ``chip_smoke.py``'s phase "multirank_train" read when
the multi-rank train step carries a planted gradient fault, on the card.

``python3 scripts/probe_multirank_train_faults.py`` copies the
checkout's ``chip_smoke.py`` and ``src/`` into one directory per fault
under ``build/faults/``, plants the fault there (a textual edit that
must match exactly once), and runs the phase from the checkout and from
each copy, each in a process of its own, with the phase's ``fail``
recording instead of raising, so that every reading is printed.  A fault
copy trains only on the meshes its fault acts on.  Prints each run's
phase JSON line and, last, one JSON line: per tree and mesh the losses'
largest relative error against one rank, the params' share past 1e-5
and largest error, and the gates that failed.  Needs one card; runs
from the root of a checkout.

``python3 scripts/probe_multirank_train_faults.py --moe`` plants the MoE
layer's faults (:data:`MOE_FAULTS`) instead, on the CPU: one copy of
``src/`` and ``tests/`` a fault, and ``tests/test_torch_multirank_moe_train.py``
run from the checkout and from each copy (pytest in a process of its
own).  Prints one JSON line: per tree the tests passed and failed, and
each failure's message — the largest readings (gradient, loss, params)
against the test's limits.  Needs no card (~2 min a tree).
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "faults"

# name: (file under src/repro_torch, the line's text, the fault, meshes)
FAULTS = {
    # copy_to's backward passes each rank's partial gradient on as it is
    "copy_no_allreduce": (
        "parallel.py",
        "return ctx.t.all_reduce(g.contiguous(), ctx.axis), None, None",
        "return g, None, None", "1x2"),
    # an FSDP leaf's gradient: this rank's rows of its own half batch's
    "fsdp_sliced": (
        "launch/steps.py",
        'return self.t.reduce_scatter(rows.contiguous(), "data")',
        'return rows[self.t.rank("data")].contiguous()', "2x1"),
    # the K/V gather's backward slices instead of reduce-scattering
    "kv_gather_sliced": (
        "parallel.py",
        "return ctx.t.reduce_scatter(g.contiguous(), ctx.axis), None, None",
        "return g[ctx.t.rank(ctx.axis)].contiguous(), None, None", "1x2"),
}


# the MoE layer's faults, each against the CPU test file MOE_TEST:
# name: (file under src/repro_torch, the line's text, the fault)
MOE_FAULTS = {
    # the router's input through copy_to: the router, softmax and aux
    # path's gradient, whole on every model rank, summed M times
    "moe_router_copy": (
        "models/moe.py", "    xt = x.reshape(T, d)\n",
        "    xt = parallel.copy_to(tensor_parallel(), x.reshape(T, d))\n"),
    # the aux's cross-rank sum by reduce_from (identity backward): each
    # rank's probabilities take 1/D of the aux gradient jax.grad gives
    "moe_aux_reduce_from": (
        "models/moe.py",
        "p = parallel.gather_from(t, probs, rows).reshape(T, E)",
        "p = parallel.reduce_from(t, torch.stack([probs if r == t.rank("
        "rows) else torch.zeros_like(probs) for r in range(t.size(rows))]"
        "), rows).reshape(T, E)"),
    # a batch every data rank holds whole routed as if split over data
    "moe_route_rows_replicated": (
        "launch/steps.py",
        'rows = "data" if self._split(batch["tokens"]) else None',
        'rows = "data"'),
}
MOE_TEST = "tests/test_torch_multirank_moe_train.py"


def plant(name: str, faults=FAULTS, dirs=("src",),
          files=("chip_smoke.py",)) -> Path:
    """A copy of ``files`` and ``dirs`` with fault ``name`` planted."""
    rel, old, new = faults[name][:3]
    tree = OUT / name
    shutil.rmtree(tree, ignore_errors=True)
    tree.mkdir(parents=True)
    for f in files:
        shutil.copy2(ROOT / f, tree)
    for d in dirs:
        shutil.copytree(ROOT / d, tree / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    path = tree / "src" / "repro_torch" / rel
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: {rel} holds {old!r} "
                         f"{text.count(old)} times, not once")
    path.write_text(text.replace(old, new))
    return tree


def run_phase(tree: str, meshes: str) -> None:
    """The phase from ``tree`` in this process, its gates recorded."""
    sys.path.insert(0, tree)
    import chip_smoke as cs
    sys.path.insert(0, str(cs.ROOT / "src"))
    failed = []
    cs.fail = failed.append
    cs.MRT_MESHES = tuple(tuple(int(v) for v in m.split("x"))
                          for m in meshes.split(","))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    pool = cs._RankPool(4)
    try:
        cs.phase_multirank_train(smi, pool)
    except KeyError:
        pass    # the return value's 2 x 1 headline, on a run without 2 x 1
    finally:
        pool.close()
    print("GATES " + json.dumps(failed), flush=True)


def run_moe_test(tree: Path) -> dict:
    """:data:`MOE_TEST` from ``tree`` on the CPU: the tests passed, and
    each failed one's message (its JUnit failure message)."""
    import os
    import xml.etree.ElementTree as ET
    xml = OUT / f"{tree.name}.xml"
    env = {**os.environ, "PYTHONPATH": str(tree / "src"),
           "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-m", "pytest", "-q",
                    "-p", "no:cacheprovider", MOE_TEST,
                    f"--junitxml={xml}"], cwd=tree, env=env,
                   capture_output=True, text=True)
    passed, failed = 0, {}
    for case in ET.parse(xml).getroot().iter("testcase"):
        bad = case.find("failure")
        if bad is None:
            bad = case.find("error")
        if bad is None:
            passed += case.find("skipped") is None
        else:
            failed[case.get("name")] = bad.get("message", "")[:400]
    return {"passed": passed, "failed": failed}


def main_moe() -> int:
    trees = {"sound": ROOT}
    trees.update({n: plant(n, MOE_FAULTS, ("src", "tests"), ())
                  for n in MOE_FAULTS})
    summary = {name: run_moe_test(tree) for name, tree in trees.items()}
    print(json.dumps({"test": MOE_TEST, "trees": summary}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", nargs=2, metavar=("TREE", "MESHES"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--moe", action="store_true",
                    help="the MoE layer's faults against the CPU test file")
    ap.add_argument("--out", default=None,
                    help="where the fault copies go (default build/faults)")
    args = ap.parse_args()
    global OUT
    OUT = Path(args.out) if args.out else OUT
    if args.run:
        run_phase(*args.run)
        return 0
    if args.moe:
        return main_moe()
    trees = {"sound": (ROOT, "1x2,2x1")}
    trees.update({n: (plant(n), f[3]) for n, f in FAULTS.items()})
    summary = {}
    for name, (tree, meshes) in trees.items():
        proc = subprocess.run(
            [sys.executable, __file__, "--run", str(tree), meshes],
            cwd=ROOT, capture_output=True, text=True)
        phase, gates = None, None
        for line in proc.stdout.splitlines():
            if line.startswith('{"phase": "multirank_train"'):
                phase = json.loads(line)
                print(line, flush=True)
            elif line.startswith("GATES "):
                gates = json.loads(line[6:])
        if phase is None or gates is None:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"{name}: the phase did not run to its end")
        summary[name] = {
            k: {"loss_max_rel_err": r["loss_max_rel_err"],
                "param_share_beyond_1e-5": r["param_share_beyond_1e-5"],
                "param_max_abs_err": r["param_max_abs_err"],
                "param_max_normwise_err": r["param_max_normwise_err"]}
            for k, r in phase["runs"].items()}
        summary[name]["gates_failed"] = [g[:160] for g in gates]
    print(json.dumps({"nvidia_smi": phase["nvidia_smi"],
                      "loss_rtol": phase["loss_rtol"], "trees": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
