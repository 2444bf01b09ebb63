"""Roofline analysis over the dry-run records: port of
``repro.launch.roofline``, priced for the NVIDIA H100 SXM.

Terms per (arch x shape x mesh):
  compute    = FLOPs / (chips x PEAK_FLOPS)       [the reference's term]
  compute_device = rank 0's FLOPs / PEAK_FLOPS    [what one card computes]
  memory     = HBM bytes / HBM_BW                 [per device; lo/hi bounds]
  collective = wire bytes per device / LINK_BW

FLOPs are the dry run's ``op_cost`` (``runtime/flops.py::cost_of`` over
the unsharded function, global) and ``device_cost`` (the same pricing of
the ops rank 0 runs in the tensor-parallel program; it exceeds the global
share where the divisibility fallback replicated a layer over
``"model"``, and the records name those layers in ``compute_note``).  The
dominant term uses ``compute_device`` where the record has one.  HBM
bytes are bounded: ``lo`` = 2 x resident state per device (params,
optimizer state or cache read and written once a step), ``hi`` = the
unfused per-op traffic of ``op_cost`` over the chips; the structural
estimate in between is the one the terms use.  Collective wire bytes are
the dry run's, from ``CommDebugMode`` and the ring formulas: weights
gathered and gradients reduce-scattered over the batch axes (FSDP), and
activations all-reduced over ``"model"`` (tensor parallelism).

The constants are the H100 SXM's published peaks, in one place
(``obs/commit_profile.py``, ``obs/ssd_profile.py`` and ``chip_smoke.py``
import them): 989 TFLOP/s dense bf16 on the tensor cores (67 TFLOP/s f32
without them, for the kernels' bounds), 3.35 TB/s of HBM3, and one 400
Gb/s NIC per card (50 GB/s) as the DGX H100 layout gives each GPU — NVLink's 450 GB/s each way inside a node of 8 is not
modelled, as the reference models one link per chip.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir artifacts/dryrun]
      [--mesh 16x16] [--csv out.csv] [--md out.md]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

PEAK_FLOPS = 989e12        # dense bf16 / H100 SXM (tensor cores)
F32_FLOPS = 67e12          # f32 FMA / H100 SXM, no tensor cores
HBM_BW = 3.35e12           # B/s / H100 SXM (HBM3)
LINK_BW = 50e9             # B/s / card: one 400 Gb/s NIC (DGX H100)


def _n_data(d: dict) -> float:
    """The batch shards of the record's mesh (the reference's
    ``chips / 16`` on the production meshes)."""
    mesh = d.get("mesh_shape")
    if not mesh:
        return d["n_devices"] / 16
    n = 1
    for name in ("pod", "data"):
        n *= mesh.get(name, 1)
    return n


def structural_mem_bytes(d: dict) -> float:
    """Fusion-aware HBM-traffic estimate per device per step.

    Components: parameter reads per pass (fwd + remat recompute + bwd for
    train), gradient + optimizer state traffic, layer-boundary activation
    tensors (~12 reads/writes of [tokens, d_model] per layer per pass),
    and KV-cache traffic for decode.  The unfused ``op_cost`` bytes stay
    the upper bound."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import SHAPES
    cfg = ARCHS[d["arch"]]
    shape = SHAPES[d["shape"]]
    chips = d["n_devices"]
    kind = d["kind"]
    mb = d.get("microbatches", 1)
    serve_tp = "tp" in d.get("tag", "")
    p_dtype = 2 if serve_tp else 4
    params_local = cfg.param_count() * p_dtype / chips
    active_local = cfg.active_param_count() * p_dtype / chips
    # activations are sharded over the batch axes only (replicated over
    # model): tokens per device = global tokens / the batch shards
    tokens_dev = shape.global_batch * (
        1 if kind == "decode" else shape.seq_len) / _n_data(d)
    act = 12 * cfg.num_layers * tokens_dev * cfg.d_model * 2  # bf16
    if kind == "train":
        passes = 3 * mb           # fwd + remat + bwd per microbatch
        traffic = params_local * (2 * passes / 2 +  # bf16 casts read
                                  4)                # grad w+r, opt r+w
        traffic += act * passes / mb
    elif kind == "prefill":
        traffic = params_local + act
        traffic += d["state_bytes_per_device"]      # cache write
    else:  # decode
        traffic = active_local + 2 * d["state_bytes_per_device"]
    return traffic


def load(dirpath: str, mesh: str | None = None, tag: str = ""):
    rows = []
    for p in sorted(Path(dirpath).glob("*.json")):
        d = json.loads(p.read_text())
        if d.get("skipped"):
            rows.append(d)
            continue
        if mesh and d["mesh"] != mesh:
            continue
        if d.get("tag", "") != tag:
            continue
        rows.append(d)
    return rows


def terms(d: dict) -> dict:
    chips = d["n_devices"]
    flops = d["op_cost"]["flops"]
    t_compute = flops / (chips * PEAK_FLOPS)
    state = d["state_bytes_per_device"]
    t_mem_lo = 2.0 * state / HBM_BW
    t_mem_hi = d["op_cost"]["bytes_unfused"] / (chips * HBM_BW)
    wire = d["collectives"]["totals"]["wire_bytes"]   # per device
    t_coll = wire / LINK_BW
    t_mem_struct = structural_mem_bytes(d) / HBM_BW
    dev = d.get("device_cost")
    t_compute_dev = dev["flops"] / PEAK_FLOPS if dev else t_compute
    terms3 = {"compute": t_compute_dev, "memory": t_mem_struct,
              "collective": t_coll}
    dominant = max(terms3, key=terms3.get)
    bound = max(terms3.values())
    mf = d["model_flops"]
    return {
        "t_compute": t_compute, "t_compute_device": t_compute_dev,
        "t_mem_lo": t_mem_lo, "t_mem_hi": t_mem_hi,
        "t_mem": t_mem_struct,
        "t_coll": t_coll, "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": mf / max(flops, 1),
        # roofline fraction: useful-model-compute time / bound time
        "roofline_frac": (mf / (chips * PEAK_FLOPS)) / max(bound, 1e-12),
        "step_s_bound": bound,
    }


_LEVER = {
    "collective": "cut the FSDP weight gathers over data (once per step "
                  "instead of per microbatch and recompute) and the "
                  "activation all-reduces over model (sequence "
                  "parallelism, overlap with compute)",
    "memory": "fuse elementwise passes; bf16 state; bigger tiles to raise "
              "arithmetic intensity",
    "compute": "remove remat waste / causal-skip attention / shard the "
               "layers the fallback replicates over model",
}


def lever(d: dict, t: dict) -> str:
    if t["dominant"] == "compute" and t["useful_ratio"] < 0.7:
        return ("compute-bound with useful/total=%.2f: cut remat recompute "
                "or attention waste" % t["useful_ratio"])
    return _LEVER[t["dominant"]]


def to_markdown(rows) -> str:
    hdr = ("| arch | shape | mesh | compute s a device (global/chips) "
           "| memory s (struct; unfused-hi)"
           " | collective s | dominant | 6ND/ops | roofline frac | lever |")
    sep = "|" + "---|" * 10
    out = [hdr, sep]
    for d in rows:
        if d.get("skipped"):
            out.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | — | — "
                       f"| — | SKIP | — | — | {d['skipped']} |")
            continue
        t = terms(d)
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} "
            f"| {t['t_compute_device']:.3f} ({t['t_compute']:.3f}) "
            f"| {t['t_mem']:.3f} ({t['t_mem_hi']:.1f}) "
            f"| {t['t_coll']:.3f} | **{t['dominant']}** "
            f"| {t['useful_ratio']:.2f} | {t['roofline_frac']:.3f} "
            f"| {lever(d, t)} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--md", default=None)
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    rows = load(args.dir, args.mesh, args.tag)
    md = to_markdown(rows)
    print(md)
    if args.md:
        Path(args.md).write_text(md + "\n")
    if args.csv:
        import csv
        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["arch", "shape", "mesh", "t_compute",
                        "t_compute_device", "t_mem",
                        "t_mem_lo", "t_mem_hi", "t_coll", "dominant",
                        "useful_ratio", "roofline_frac"])
            for d in rows:
                if d.get("skipped"):
                    continue
                t = terms(d)
                w.writerow([d["arch"], d["shape"], d["mesh"],
                            t["t_compute"], t["t_compute_device"], t["t_mem"],
                            t["t_mem_lo"],
                            t["t_mem_hi"], t["t_coll"], t["dominant"],
                            t["useful_ratio"], t["roofline_frac"]])


if __name__ == "__main__":
    main()
