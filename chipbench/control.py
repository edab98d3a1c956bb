"""The readings that the limits of ``correct`` are set from (not run by
the benchmark's own runs):

    python3 chipbench/control.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9]

For each of ``--seeds``, the program's readings: a train cell's checked
steps and read-backs, a recover cell's chain and one recovery, each
against the reference (the lower readings). For each of
``--control-seeds``, the control and the faults put in the program's
place: the reference computed in float8 (every cell), the reference
with half of each batch left out (train cells), and the replay computed
in bfloat16 (recover cells). One JSON line per reading.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def readings(cell, device, seed: int, control: bool):
    import torch
    from chipbench import harness
    drv = harness.driver(cell)
    if cell.traffic["kind"] == "train":
        if not control:
            tr = drv.Trainer(cell, device, seed)
            prog = tr.prog
            tr.close()
            yield "program", drv.numbers_of(prog, drv.reference(
                cell, device, seed), tr.lowdiff)
            return
        lowdiff = cell.traffic["strategy"] == "lowdiff"
        ref = drv.reference(cell, device, seed)
        for what, kw in (("control_fp8", {"fp8": True}),
                         ("fault_half_batch", {"half": True})):
            got = drv.as_program(drv.reference(cell, device, seed, **kw))
            yield what, drv.numbers_of(got, ref, lowdiff)
        return
    ch = drv.Chain(cell, device, seed)
    if control:
        ch.close()
        yield "control_bf16_replay_fp8_start", drv.judge(
            cell, device, seed, ch, None, [], fp8=True)
        return
    last, ok = ch.recover()
    fps = [drv.fingerprint(last)]
    ch.close()
    out = drv.judge(cell, device, seed, ch, last, fps)
    out["at_chain_end"] = float(ok)
    del last
    torch.cuda.empty_cache()
    yield "program", out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    import torch
    from chipbench import harness
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seeds, control in ((args.seeds, False), (args.control_seeds, True)):
        for s in filter(None, seeds.split(",")):
            for what, numbers in readings(cell, device, int(s), control):
                print(json.dumps({"workload": args.workload, "seed": int(s),
                                  "reading": what, "numbers": numbers}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
