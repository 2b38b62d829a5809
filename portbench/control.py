"""Read a cell's lower-precision control on the card.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        --passes 6

For each seed: the cell's set-up and ``--passes`` passes at its own size
on ``cuda:0``, as a run makes them; then the judge's numbers for the
program's passes (the lower readings) and for the control in its place
(``reference/control.py``: the reference computed in float32; the upper
readings), over the same sampled lanes.  One JSON line per seed.  The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--passes", type=int, required=True)
    args = ap.parse_args(argv)

    from portbench import harness
    from portbench.reference import control, judge
    cell = harness.load_cell(ROOT, args.workload)
    drv, traffic = cell.driver, cell.spec["traffic"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        state = drv.setup(cell.cfg, traffic, seed, "cuda:0")
        outs = [drv.run_pass(state, drv.request(state, i))
                for i in range(args.passes)]
        t1 = time.perf_counter()
        shape = (len(state.candidates), int(traffic["traces_per_pass"]))
        picks = judge.sample(outs, shape, seed, int(traffic["check_lanes"]))
        prog, _ = judge.judge(cell.cfg, state.strategies, state.pool,
                              drv.candidates(state), outs, picks)
        t2 = time.perf_counter()
        cands, ctl_passes = control.view(cell.cfg, state.strategies,
                                         state.pool, outs, picks)
        ctl, _ = judge.judge(cell.cfg, state.strategies, state.pool, cands,
                             ctl_passes, picks)
        t3 = time.perf_counter()
        print(json.dumps({
            "cell": cell.name, "seed": seed, "passes": len(outs),
            "lanes_checked": len(picks),
            "program": {k: v for k, (v, _) in prog.items()},
            "control": {k: v for k, (v, _) in ctl.items()},
            "program_correct": judge.correct(prog),
            "control_correct": judge.correct(ctl),
            "seconds": {"setup_and_passes": t1 - t0, "judge": t2 - t1,
                        "control": t3 - t2}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
