"""Roofline terms of a counted call (src/repro/launch/roofline.py), on the
NVIDIA H100 SXM's peaks.

Three terms per (arch x shape x mesh) cell, all in seconds:

    compute    = flops_bf16 / 989e12 + flops_fp32 / 67e12
                 + ops_int8 / 1979e12                      (a chip)
    memory     = hbm_bytes / 3.35e12                       (a chip)
    collective = coll_bytes / 450e9                        (a chip)

The inputs come from ``launch/op_cost.py``'s counter (the port has no
HLO). JAX's compute term is one bf16 term; the port's is split by the
dtype each product runs in: the head (``matmul_f32``), the training
attention's einsums and the SSD scan's run in fp32 with TF32 off, at
67 TFLOP/s, and a single bf16 term would understate them 15x.
``flops`` stays the sum of the three classes, as JAX's ``flops``.

A count of eager ops is this implementation's traffic, not a bound on
the work: every elementwise pass is charged, and a change that removes
passes lowers it. It is no yardstick to hold an implementation to; a
work bound (``model_flops_step``, the kernels' formulas of the data)
is, and the count stands beside it.

The link term has not been checked against a multi-GPU run: the port has
run on one card, with no NCCL.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet), a GPU
HBM_BW = 3.35e12                # B/s, HBM3
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, fp32 on the CUDA cores (no TF32)
PEAK_OPS_INT8 = 1979e12         # OP/s, int8 tensor cores, dense
NVLINK_BW = 450e9               # B/s a GPU a direction (NVLink 4: 900 GB/s
                                # both directions together)
HBM_PER_CHIP = 80 * 10**9       # bytes (80 GB, decimal, the data sheet's)


@dataclasses.dataclass
class Roofline:
    """Byte and FLOP inputs are PER CHIP; ``model_flops`` is GLOBAL
    (6 N D). ``flops`` is every contraction FLOP a chip, of which
    ``flops_fp32`` run in fp32 and ``ops_int8`` in int8; the rest run at
    the bf16 rate."""
    flops: float                 # per-chip contraction flops, all dtypes
    hbm_bytes: float             # per-chip bytes moved
    coll_bytes: float            # per-chip collective bytes
    chips: int
    model_flops: float = 0.0     # global useful flops
    flops_fp32: float = 0.0      # of ``flops``: fp32 products
    ops_int8: float = 0.0        # of ``flops``: int8 products

    @property
    def flops_bf16(self) -> float:
        return self.flops - self.flops_fp32 - self.ops_int8

    @property
    def t_compute(self) -> float:
        return (self.flops_bf16 / PEAK_FLOPS_BF16
                + self.flops_fp32 / PEAK_FLOPS_FP32
                + self.ops_int8 / PEAK_OPS_INT8)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def step_time(self) -> float:
        """Roofline lower bound on the step's time (the largest of the
        three terms: perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS over the global counted flops (remat and
        redundancy waste)."""
        tot = self.flops * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based MFU bound implied by the three terms: useful
        flops per second at the roofline step time over the bf16 peak."""
        if not self.model_flops:
            return 0.0
        t = self.step_time
        return self.model_flops / (t * self.chips * PEAK_FLOPS_BF16)

    def as_dict(self):
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "flops_bf16_per_chip": self.flops_bf16,
            "flops_fp32_per_chip": self.flops_fp32,
            "ops_int8_per_chip": self.ops_int8,
        }


def roofline_from_cost(cost, chips: int,
                       model_flops: float = 0.0) -> Roofline:
    """The terms of an ``op_cost.Cost`` of the whole mesh's work (the
    port runs a mesh's logical shards on one device): its flops and bytes
    spread evenly over ``chips``; collective bytes are a participant's
    already."""
    return Roofline(
        flops=cost.flops / chips, hbm_bytes=cost.bytes / chips,
        coll_bytes=cost.coll_bytes, chips=chips, model_flops=model_flops,
        flops_fp32=cost.flops_by_dtype.get("fp32", 0) / chips,
        ops_int8=cost.flops_by_dtype.get("int8", 0) / chips)


def model_flops_train(cfg, n_tokens: int, active_params: int) -> float:
    """6*N*D (fwd 2ND + bwd 4ND)."""
    return 6.0 * active_params * n_tokens


def model_flops_step(kind: str, cfg, seq: int, batch: int,
                     active_params: int) -> float:
    if kind == "train":
        return 6.0 * active_params * seq * batch
    if kind == "prefill":
        return 2.0 * active_params * seq * batch
    return 2.0 * active_params * batch      # decode: one token per slot
