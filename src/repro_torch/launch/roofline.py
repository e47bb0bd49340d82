"""Roofline report: three terms per (arch x shape x mesh) cell of the dry run.

Reads the dry run's records (``experiments/dryrun/*.json``,
:mod:`repro_torch.launch.dryrun`) and gives, per rank and step:

    compute term    = per-rank FLOPs / 989 TFLOP/s (bf16 dense)
    memory term     = per-rank HBM bytes / 3.35 TB/s
    collective term = per-rank wire bytes within a pod / 450 GB/s
                      (NVLink 4, one direction)
                      + cross-pod wire bytes / 50 GB/s (a 400 Gb/s NIC a
                      card), the latter also reported apart (``dcn_s``,
                      the reference's name for its cross-pod link)

All three in seconds; the largest is the bound.  ``MFU`` is
MODEL_FLOPS / (ranks x peak x bound term): the share of the peak the cell
would reach at its dominant bound.

The constants are the NVIDIA H100 SXM's datasheet values (the card that
``nvidia-smi --query-gpu=name,power.limit`` names "NVIDIA H100 80GB
HBM3, 700.00 W" on the machine the port runs on), not measurements: the
dense bf16 tensor-core peak, the HBM3 rate and capacity, NVLink 4's
per-direction rate, and one 400 Gb/s NIC a card between pods.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir experiments/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores, a card (datasheet)
HBM_BW = 3.35e12     # bytes/s a card (datasheet)
NVLINK_BW = 450e9    # bytes/s a card, one direction, NVLink 4 (datasheet)
NIC_BW = 50e9        # bytes/s a card across pods: 400 Gb/s (datasheet)
HBM_GB = 80          # HBM capacity a card (datasheet)


def load(dirname: str) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def terms(rec: dict) -> dict:
    ct = rec["hlo_flops"] / PEAK_FLOPS
    mt = rec["hlo_bytes"] / HBM_BW
    intra = (rec["collective_wire_bytes"] - rec["collective_cross_pod_bytes"]) / NVLINK_BW
    cross = rec["collective_cross_pod_bytes"] / NIC_BW
    lt = intra + cross
    bound = max(ct, mt, lt)
    dom = {ct: "compute", mt: "memory", lt: "collective"}[bound]
    n = rec["n_chips"]
    useful = rec["model_flops"] / n / PEAK_FLOPS  # s of pure model math a rank
    mfu = useful / bound if bound > 0 else 0.0
    mem = rec.get("mem", {})
    hbm = (mem.get("argument_bytes", 0) + mem.get("temp_bytes", 0)
           + mem.get("output_bytes", 0) - mem.get("alias_bytes", 0))
    return {
        "compute_s": ct, "memory_s": mt, "collective_s": lt, "dcn_s": cross,
        "bound": dom, "mfu": mfu,
        "flops_ratio": rec["model_flops"] / max(rec["hlo_flops"] * n, 1),
        "hbm_gib": hbm / 2**30,
        "upcast_gib": rec.get("bf16_upcast_bytes", 0) / 2**30,
    }


def advice(rec: dict, t: dict) -> str:
    if rec.get("kind") == "em_round":
        return ("matcher-dominated, as the paper's framework predicts: "
                "the bitset exchange is structurally cheap; fast greedy "
                "re-activation rounds are the lever")
    if t["bound"] == "collective":
        if rec.get("kind") == "train" and rec["params"] < 2e9:
            return "TP-16 too wide for this size: drop `model` use (pure DP/FSDP)"
        if rec.get("arch", "").startswith(("moonshot", "llama4", "jamba")):
            return "EP all-to-all + megatron ARs dominate: larger MoE groups / fewer AR hops"
        return "overlap all-reduces with compute, reduce-scatter gradients"
    if t["bound"] == "memory":
        if rec.get("kind") != "train":
            return "decode is KV-bandwidth bound (expected): bigger batch amortizes weights"
        return "fuse/remat to cut activation traffic; bf16 everywhere"
    return "compute-bound: at roofline when MFU -> 1; cut remat/causal waste"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="16x16", help="mesh to tabulate")
    ap.add_argument("--md", action="store_true", help="emit markdown")
    args = ap.parse_args(argv)

    recs = [r for r in load(args.dir) if r.get("status") == "ok"]
    recs = [r for r in recs if r["mesh"] == args.mesh]
    recs.sort(key=lambda r: (r["arch"], r["shape"]))

    hdr = ["arch", "shape", "compute_s", "memory_s", "collective_s",
           "bound", "MFU", "model/hlo", "HBM_GiB"]
    if args.md:
        print("| " + " | ".join(hdr) + " |")
        print("|" + "---|" * len(hdr))
    else:
        print(f"{'arch':24s} {'shape':12s} {'comp_s':>9s} {'mem_s':>9s} "
              f"{'coll_s':>9s} {'bound':>10s} {'MFU':>6s} {'m/h':>5s} {'GiB':>6s}")
    for r in recs:
        t = terms(r)
        row = [r["arch"], r["shape"], f"{t['compute_s']:.4f}",
               f"{t['memory_s']:.4f}", f"{t['collective_s']:.4f}",
               t["bound"], f"{t['mfu']:.3f}", f"{t['flops_ratio']:.2f}",
               f"{t['hbm_gib']:.1f}"]
        if args.md:
            print("| " + " | ".join(row) + " |")
        else:
            print(f"{row[0]:24s} {row[1]:12s} {row[2]:>9s} {row[3]:>9s} "
                  f"{row[4]:>9s} {row[5]:>10s} {row[6]:>6s} {row[7]:>5s} {row[8]:>6s}")
    print()
    for r in recs:
        t = terms(r)
        print(f"- {r['arch']} x {r['shape']}: {t['bound']}-bound — {advice(r, t)}")


if __name__ == "__main__":
    main()
