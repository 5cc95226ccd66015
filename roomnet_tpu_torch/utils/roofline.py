"""Analytic roofline of the RoomNet forward (port of
roomnet_tpu/utils/roofline.py), with the H100's constants.

The FLOP count is exact (conv, dense and resize contractions from the
RoomNetConfig geometry); the bytes are the activation traffic of one group
per conv, pool + BN, residual and dense layer (the JAX module's fusion
groups, whose FLOPs and bytes this module reproduces for any config and
batch). Each group is bound by its operations or its bytes at the peak
rates given; the model leaves out padding, layouts and weight reads, so it
bounds from below.

Default peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989
TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them, 3.35 TB/s
HBM. `summarize(..., dtype_bytes=4, peak_flops=H100_F32_PEAK_FLOPS)` is the
f32 forward's. This is the whole forward's yardstick; chip_smoke.py's
per-kernel bound counts each kernel's own bytes and operations.
"""

from __future__ import annotations

import dataclasses

H100_BF16_PEAK_FLOPS = 989e12
H100_F32_PEAK_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class OpGroup:
    name: str
    flops: float  # multiply-adds * 2
    hbm_bytes: float  # activation reads + writes (weights negligible)

    def ideal_s(self, peak_flops: float, hbm_bw: float) -> float:
        return max(self.flops / peak_flops, self.hbm_bytes / hbm_bw)

    def hbm_bound(self, peak_flops: float, hbm_bw: float) -> bool:
        return self.hbm_bytes / hbm_bw > self.flops / peak_flops


def forward_groups(cfg, batch: int, dtype_bytes: int = 2) -> list[OpGroup]:
    """One OpGroup per group of the serving forward, in its order: per conv
    (read its input, write its output), per pool + BN, per residual (the
    TF1 resize as two contractions, the add and the BN) and per dense
    layer (its kernel read as well)."""
    groups = []
    s, in_ch, k = cfg.im_side, 3, cfg.kernel_size
    for bi, (filters, depth) in enumerate(zip(cfg.block_filters, cfg.block_depths)):
        pool = cfg.block_pools[bi]
        res_side = None
        for d in range(depth):
            cin = in_ch if d == 0 else filters
            s_conv = s - (k - 1)
            groups.append(OpGroup(name=f"b{bi + 1}.conv{d}",
                                  flops=2.0 * batch * s_conv ** 2 * filters * k * k * cin,
                                  hbm_bytes=dtype_bytes * batch * (s ** 2 * cin + s_conv ** 2 * filters)))
            s = s_conv
            if pool is not None:
                pk, pst = pool
                s_pool = (s - pk) // pst + 1
                # About k² adds per output and the BN affine.
                groups.append(OpGroup(name=f"b{bi + 1}.pool{d}",
                                      flops=float(batch) * s_pool ** 2 * filters * (pk * pk + 4),
                                      hbm_bytes=dtype_bytes * batch * (s ** 2 + s_pool ** 2) * filters))
                s = s_pool
            if d == 0:
                res_side = s
        if depth > 1:
            # Rows then columns; reads res_in and x, writes the sum.
            inter = res_side * s
            groups.append(OpGroup(name=f"b{bi + 1}.residual",
                                  flops=2.0 * batch * cfg_filters_resize(filters)
                                  * (res_side * inter + s * s * res_side),
                                  hbm_bytes=dtype_bytes * batch * filters * (res_side ** 2 + 2 * s ** 2)))
        in_ch = filters
    d_in = s * s * cfg.block_filters[-1]
    for di, units in enumerate(tuple(cfg.dense_units) + (cfg.num_classes,)):
        groups.append(OpGroup(name=f"dense{di}", flops=2.0 * batch * d_in * units,
                              hbm_bytes=dtype_bytes * batch * (d_in + units) + dtype_bytes * d_in * units))
        d_in = units
    return groups


def cfg_filters_resize(filters: int) -> float:
    """The resize contractions' width: they contract a spatial axis, and the
    channels ride along."""
    return float(filters)


def summarize(cfg, batch: int, *, dtype_bytes: int = 2, peak_flops: float = H100_BF16_PEAK_FLOPS,
              hbm_bw: float = H100_HBM_BYTES_PER_S, measured_s: float | None = None) -> dict:
    """The forward's totals and ideal time at `batch`; with `measured_s`
    (one forward's time, in seconds), the achieved rate and shares of the
    peak and of the ideal. `pct_bf16_roofline` keeps the JAX package's
    name: it is the share of `peak_flops`, whatever that peak's type."""
    groups = forward_groups(cfg, batch, dtype_bytes)
    total_flops = sum(g.flops for g in groups)
    total_bytes = sum(g.hbm_bytes for g in groups)
    ideal = sum(g.ideal_s(peak_flops, hbm_bw) for g in groups)
    hbm_ideal = sum(g.ideal_s(peak_flops, hbm_bw) for g in groups if g.hbm_bound(peak_flops, hbm_bw))
    out = {
        "batch": batch,
        "total_gflops": total_flops / 1e9,
        "total_hbm_GB": total_bytes / 1e9,
        "ideal_ms": ideal * 1e3,
        "hbm_bound_time_fraction": hbm_ideal / ideal if ideal else 0.0,
    }
    if measured_s is not None:
        out["measured_ms"] = measured_s * 1e3
        out["achieved_tflops"] = total_flops / measured_s / 1e12
        out["pct_bf16_roofline"] = 100.0 * total_flops / measured_s / peak_flops
        out["pct_of_ideal"] = 100.0 * ideal / measured_s
    return out
