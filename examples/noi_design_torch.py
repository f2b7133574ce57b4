"""NoI design walkthrough (the paper's §3.3 flow, end to end), on the
PyTorch port's Plane B (``repro_torch.core``, numpy only: it prints
what ``examples/noi_design.py`` prints, line for line, and runs on no
device):

  workload → phase traffic → MOO-STAGE search over placements/links →
  Pareto front → pick min-EDP design → full-system simulation,
  plus the 3D-HI variant with thermal + ReRAM-noise objectives (eq. 20).

Run:  PYTHONPATH=src python examples/noi_design_torch.py [--chiplets 36]
"""
import argparse
import random

import numpy as np

from repro_torch.config import get_config
from repro_torch.core.moo import moo_stage, local_search, Archive
from repro_torch.core.noi import evaluate_noi, mesh_baseline_eval
from repro_torch.core.placement import initial_placement
from repro_torch.core.simulator import simulate_2p5d_hi
from repro_torch.core.thermal import (hi3d_stack_report, moo_objectives_3d,
                                baseline_stack_report)
from repro_torch.core.traffic import Workload, transformer_phases


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chiplets", type=int, default=36, choices=(36, 64, 100))
    ap.add_argument("--arch", default="bert-base")
    ap.add_argument("--seq-len", type=int, default=64)
    args = ap.parse_args()

    w = Workload.from_config(get_config(args.arch), seq_len=args.seq_len)
    phases = transformer_phases(w)
    mesh_ev = mesh_baseline_eval(args.chiplets, phases)
    print(f"workload: {args.arch} n={args.seq_len}, {args.chiplets} chiplets")
    print(f"naive-mesh baseline: mu={mesh_ev.mu/1e6:.2f}MB sigma={mesh_ev.sigma/1e6:.2f}MB")

    # -- 2-objective MOO (eq. 10) ------------------------------------------
    def objective(p):
        ev = evaluate_noi(p, phases)
        return (ev.mu / mesh_ev.mu, ev.sigma / mesh_ev.sigma)

    ref = (2.0, 2.0)
    res = moo_stage(args.chiplets, objective, ref, iterations=4, ls_steps=25)
    local_search(initial_placement(args.chiplets), objective, res.archive,
                 random.Random(0), max_steps=25)
    front = sorted(res.archive.objs)
    print(f"\nMOO-STAGE: {res.n_evals} evaluations, "
          f"{len(front)} Pareto designs, PHV={res.archive.phv(ref):.3f}")
    for mu, sg in front[:6]:
        print(f"  mu_norm={mu:.3f}  sigma_norm={sg:.3f}")

    # -- pick min-EDP design via the full-system simulator ------------------
    best, best_edp = None, float("inf")
    for design, _ in zip(res.archive.designs, res.archive.objs):
        sim = simulate_2p5d_hi(w, args.chiplets, placement=design)
        if sim.edp < best_edp:
            best, best_edp = sim, sim.edp
    print(f"\nmin-EDP design: latency={best.latency_s*1e3:.1f}ms "
          f"energy={best.energy_j:.2f}J EDP={best.edp:.4f}")

    # -- 3D-HI: add thermal + noise objectives (eq. 20) ---------------------
    p0 = initial_placement(args.chiplets)
    ev0 = evaluate_noi(p0, phases)
    t4 = moo_objectives_3d(p0, ev0.mu, ev0.sigma)
    print(f"\n3D-HI 4-objective point (eq. 20): mu={t4[0]/1e6:.2f}MB "
          f"sigma={t4[1]/1e6:.2f}MB T_obj={t4[2]:.1f} noise_sigma={t4[3]:.2e}")
    hi = hi3d_stack_report(args.chiplets)
    print(f"3D-HI stack peak temp: {hi.peak_c:.1f}C "
          f"(DRAM-feasible: {hi.dram_feasible})")
    for kind in ("haima", "transpim"):
        r = baseline_stack_report(kind)
        print(f"original {kind} 3-D stack: {r.peak_c:.1f}C "
              f"(DRAM-feasible: {r.dram_feasible})   <- Fig. 11")


if __name__ == "__main__":
    main()
