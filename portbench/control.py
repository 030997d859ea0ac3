"""The readings a cell's limits are set from, on the card or (at a test's
size) on the CPU.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3
        [--seconds S] [--faults] [--out FILE]

For each seed, in one process:

  * program (unless --no-program): a run of the cell
    (portbench.harness.run) with a window of S seconds at the cell's own
    load, and its compared numbers;
  * control: the plain reference computed in bfloat16, the precision
    below the float32 the configuration states, put in the program's
    place on check_frames frames of the cell's path drawn from the seed,
    against the reference in float32;
  * with --faults, runs with the timed path broken underneath (FAULTS):
    each must come out not correct.

Prints one JSON line a reading and, last, each number's lower reading
(the largest the program gave) and upper reading (the smallest the
control gave).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict


class Stale:
    """A render that returns its first frame again on every call: a step
    that leaves its state unchanged."""

    def __init__(self, prog):
        self.prog, self.to_rgb8, self.first = prog, prog.to_rgb8, None

    def render(self, cam):
        if self.first is None:
            self.first = self.prog.render(cam)
        return self.first


class Half:
    """Half of each frame's work left out: its right half of the columns
    left at the clear colour."""

    def __init__(self, prog):
        self.prog, self.to_rgb8 = prog, prog.to_rgb8

    def render(self, cam):
        color = self.prog.render(cam).clone()
        clear = self.prog.engine.uniforms["clear_color"]
        w = color.shape[1]
        for c in range(4):
            color[:, w // 2:, c] = float(clear[c])
        return color


class Altered:
    """Every frame altered where it is produced: every 8th row's red
    raised by 24 levels."""

    def __init__(self, prog):
        self.prog = prog

    def render(self, cam):
        return self.prog.render(cam)

    def to_rgb8(self, color):
        rgb = self.prog.to_rgb8(color).clone()
        rgb[::8, :, 0] = (rgb[::8, :, 0].int() + 24).clamp(max=255).to(
            rgb.dtype)
        return rgb


FAULTS = {"stale": Stale, "half": Half, "altered": Altered}


def control_reading(cell_name: str, seed: int, device: str = "cuda",
                    over: Dict = None) -> Dict:
    """The worst numbers of the bfloat16 reference against the float32
    one over the cell's check_frames frames of the path, drawn from the
    seed."""
    import torch
    from portbench import gen, harness
    cell = harness.cell_of(cell_name)
    cfg = cell["module"]
    inputs = cfg.make_inputs(seed, over)
    cam = cell["camera"]
    rng = gen.rng_of(seed, 9)
    ks = rng.integers(0, int(cam["k_span"]) + 1, int(cell["check_frames"]))
    ref = cfg.Reference(inputs, device, torch.float32)
    low = cfg.Reference(inputs, device, torch.bfloat16)
    per = [harness.compare(low.frame(harness.camera_at(cam, int(k)))
                           .cpu().numpy(),
                           ref.frame(harness.camera_at(cam, int(k))))
           for k in ks]
    return {k: max(p[k] for p in per) for k in harness.CHECKS}


def readings(cell_name: str, seeds, seconds: float, faults: bool,
             program: bool = True, device: str = "cuda", over: Dict = None):
    """Yield one reading a seed and kind."""
    from portbench import harness
    for seed in seeds:
        if program:
            r, _ = harness.run(cell_name, seed, seconds, False,
                               device=device, over=over)
            yield {"kind": "program", "seed": seed, "correct": r["correct"],
                   **{k: r["checks"][f"{k}_worst"]["value"]
                      for k in harness.CHECKS}}
        yield {"kind": "control", "seed": seed,
               **control_reading(cell_name, seed, device, over)}
        if faults:
            for name, fault in FAULTS.items():
                r, _ = harness.run(cell_name, seed, seconds, False,
                                   device=device, over=over, fault=fault)
                yield {"kind": f"fault.{name}", "seed": seed,
                       "correct": r["correct"],
                       **{k: r["checks"][f"{k}_worst"]["value"]
                          for k in harness.CHECKS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--no-program", action="store_true",
                    help="the control (and faults) alone")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    from portbench import harness
    seeds = [int(s) for s in a.seeds.split(",")]
    rows = []
    for row in readings(a.workload, seeds, a.seconds, a.faults,
                        not a.no_program):
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for k in harness.CHECKS:
        prog = [r[k] for r in rows if r["kind"] == "program"]
        ctrl = [r[k] for r in rows if r["kind"] == "control"]
        summary[k] = {"lower": max(prog, default=None),
                      "upper": min(ctrl, default=None)}
    print(json.dumps({"workload": a.workload, "summary": summary}))
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
