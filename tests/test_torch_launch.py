"""The port's launch tooling (repro_torch.launch: roofline, op_cost,
dryrun, report) against the JAX package's (repro.launch.roofline,
hlo_cost and report), at smoke sizes on the CPU and on "meta".

JAX's dry-run, attr and perf set ``XLA_FLAGS`` at import; nothing here
imports them. The JAX side is jitted once a module on the one CPU
device.

  * ``Roofline.as_dict`` equals JAX's on the same inputs, JAX's
    constants patched to the H100's for the test; the fp32 and int8
    compute terms by hand.
  * ``model_flops_step`` equals JAX's for every arch and kind.
  * JAX's four analyzer cases (tests/test_sharding.py) on the counter.
  * The smoke yi-6b forward's FLOPs equal ``hlo_cost.analyze`` of JAX's
    jitted forward; the train step's equal JAX's plus the p.v products
    torch.utils.checkpoint recomputes in each attention block's backward
    (XLA drops them: the backward needs p, not p.v).
  * Depth extrapolation equals the full count, exactly, on the smoke
    dense, MoE and hybrid configs, for each kind of cell.
  * The collectives of the FSDP step on a (2, 2) mesh.
  * ``report``'s tables equal JAX's but for the "80G" label, and it runs
    on a record of the port's ``lower_cell``.
  * A knn-build cell on the CPU at a small n.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import hlo_cost
from repro.launch import report as jreport
from repro.launch import roofline as jroof
from repro.models import abstract_tree as jabstract_tree
from repro.models import active_param_count as jactive_param_count
from repro.models import model_schema as jmodel_schema
from repro.models.model import forward as jforward
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro.train import optimizer as jopt
from repro_torch.configs import (
    ShapeSpec,
    get_config,
    get_smoke_config,
    list_archs,
)
from repro_torch.launch import dryrun, make_test_mesh, op_cost, report
from repro_torch.launch import roofline as roof
from repro_torch.models import (
    active_param_count,
    forward,
    init_tree,
    model_schema,
    spec_tree,
)
from repro_torch.models.params import tree_leaves
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train import optimizer as opt

SMOKE_TRAIN = ShapeSpec("smoke_train", 32, 4, "train")
SMOKE_PREFILL = ShapeSpec("smoke_prefill", 48, 2, "prefill")
SMOKE_DECODE = ShapeSpec("smoke_decode", 64, 2, "decode")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

ROOF_CASES = [
    (3.1e12, 2.2e9, 1.0e6, 256, 4.0e14),     # compute-bound
    (1.0e9, 7.5e11, 2.0e8, 256, 0.0),        # memory-bound, no model flops
    (1.0e8, 1.0e6, 9.0e11, 512, 1.0e12),     # collective-bound
]


@pytest.mark.parametrize("case", ROOF_CASES)
def test_roofline_as_dict_matches_jax(case, monkeypatch):
    monkeypatch.setattr(jroof, "PEAK_FLOPS_BF16", roof.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jroof, "HBM_BW", roof.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW_PER_LINK", roof.NVLINK_BW / 4)
    flops, hbm, coll, chips, mf = case
    want = jroof.Roofline(flops, hbm, coll, chips, mf).as_dict()
    got = roof.Roofline(flops, hbm, coll, chips, mf).as_dict()
    assert {k: got[k] for k in want} == want
    assert got["flops_bf16_per_chip"] == flops
    assert got["flops_fp32_per_chip"] == got["ops_int8_per_chip"] == 0


def test_roofline_compute_term_by_dtype():
    # one second of each: bf16 (the rest), fp32, int8
    r = roof.Roofline(flops=989e12 + 67e12 + 1979e12, hbm_bytes=0.0,
                      coll_bytes=0.0, chips=1, flops_fp32=67e12,
                      ops_int8=1979e12)
    assert r.flops_bf16 == pytest.approx(989e12, rel=1e-12)
    assert r.t_compute == pytest.approx(3.0, rel=1e-12)
    assert r.bottleneck == "compute"
    d = r.as_dict()
    assert d["flops_fp32_per_chip"] == 67e12
    assert d["ops_int8_per_chip"] == 1979e12
    # the memory and link terms
    r2 = roof.Roofline(0.0, 3.35e12, 450e9, 1)
    assert r2.t_memory == r2.t_collective == 1.0


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_model_flops_step_matches_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    n, jn = active_param_count(cfg), jactive_param_count(jcfg)
    assert n == jn
    for kind, seq, batch in (("train", 4096, 256), ("prefill", 32768, 32),
                             ("decode", 32768, 128)):
        assert roof.model_flops_step(kind, cfg, seq, batch, n) == \
            jroof.model_flops_step(kind, jcfg, seq, batch, jn)
    assert roof.model_flops_train(cfg, 1000, n) == \
        jroof.model_flops_train(jcfg, 1000, jn)


# ---------------------------------------------------------------------------
# the counter on JAX's analyzer cases (tests/test_sharding.py)
# ---------------------------------------------------------------------------

def _randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_counter_loop_free_mlp_matches_hlo_cost():
    def f(x, w1, w2):
        return torch.relu(x @ w1) @ w2

    def jf(x, w1, w2):
        return jax.nn.relu(x @ w1) @ w2
    m, k, n = 256, 512, 1024
    got = op_cost.analyze(f, _randn(m, k), _randn(k, n), _randn(n, m))
    want = 2 * m * k * n + 2 * m * n * m
    assert got.flops == got.flops_by_dtype["fp32"] == want
    sh = jax.ShapeDtypeStruct
    c = jax.jit(jf).lower(sh((m, k), np.float32), sh((k, n), np.float32),
                          sh((n, m), np.float32)).compile()
    ref = hlo_cost.analyze(c.as_text()).flops
    assert abs(got.flops - ref) / ref < 0.02
    # eager traffic: each op's operands and output, the relu a pass of
    # its own
    assert got.bytes == 4 * ((m * k + k * n + m * n) + 2 * m * n
                             + (m * n + n * m + m * m))


def test_counter_multiplies_python_loops():
    def f(x):
        c = x
        for _ in range(10):
            c = c @ c
        return c
    got = op_cost.analyze(f, _randn(128, 128))
    assert got.flops == 10 * 2 * 128 ** 3


def test_counter_nested_loops():
    def f(x):
        c = x
        for _ in range(5):
            for _ in range(3):
                c = c @ c
        return c
    got = op_cost.analyze(f, _randn(64, 64))
    assert got.flops == 15 * 2 * 64 ** 3


def test_counter_charges_stacked_weight_slices():
    """The scan-stacked-weights case: each step reads its slice of the
    stack (a view: no traffic), not the stack."""
    def f(ws, x):
        c = x
        for i in range(ws.shape[0]):
            c = torch.tanh(c @ ws[i])
        return c
    got = op_cost.analyze(f, _randn(6, 256, 256), _randn(256, 256))
    ideal = 6 * 3 * 256 * 256 * 4        # per step: read w, read c, write c
    assert got.bytes == ideal + 6 * 2 * 256 * 256 * 4     # + tanh's pass
    assert got.bytes < 6 * ideal


# ---------------------------------------------------------------------------
# the smoke yi-6b forward and train step against JAX's hlo_cost
# ---------------------------------------------------------------------------

def _pv_recompute_flops(cfg, batch: int, seq: int, m: int) -> int:
    """The p.v products torch.utils.checkpoint runs again in the backward
    of each (q chunk, kv chunk) block of the plain chunked attention:
    2 (B/m) H cq ckv Dv a block, a layer, a microbatch."""
    cq, ck = min(cfg.attn_chunk_q, seq), min(cfg.attn_chunk_kv, seq)
    blocks = (-(-seq // cq)) * (-(-seq // ck))
    return (cfg.n_layers * m * blocks
            * 2 * (batch // m) * cfg.n_heads * cq * ck * cfg.d_head)


@pytest.fixture(scope="module")
def yi_smoke():
    cfg = get_smoke_config("yi-6b")
    params = init_tree(torch.Generator().manual_seed(0), model_schema(cfg))
    jcfg = jget_smoke("yi-6b")
    return cfg, params, jcfg, jabstract_tree(jmodel_schema(jcfg))


def test_forward_flops_equal_hlo_cost(yi_smoke):
    cfg, params, jcfg, jparams = yi_smoke
    tokens = torch.randint(0, cfg.vocab, (2, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    got = op_cost.analyze(forward, params, {"tokens": tokens}, cfg)
    sh = jax.ShapeDtypeStruct
    text = jax.jit(lambda p, b: jforward(p, b, jcfg)).lower(
        jparams, {"tokens": sh((2, 64), np.int32)}).compile().as_text()
    want = hlo_cost.analyze(text).flops
    assert got.flops == want == 96468992


def test_train_step_flops_are_jax_plus_the_pv_recompute(yi_smoke):
    cfg, params, jcfg, jparams = yi_smoke
    assert cfg.remat == jcfg.remat == "none"
    b, seq, m = 4, 64, 2
    state = opt.init(params)
    g = torch.Generator().manual_seed(2)
    batch = {k: torch.randint(0, cfg.vocab, (b, seq), dtype=torch.int32,
                              generator=g) for k in ("tokens", "labels")}
    got = op_cost.analyze(make_train_step(cfg, TrainConfig(microbatches=m)),
                          params, state, batch)
    sh = jax.ShapeDtypeStruct
    jstep = jmake_train_step(jcfg, JTrainConfig(microbatches=m))
    jbatch = {k: sh((b, seq), np.int32) for k in ("tokens", "labels")}
    text = jax.jit(jstep).lower(jparams, jopt.abstract_init(jparams),
                                jbatch).compile().as_text()
    want = hlo_cost.analyze(text).flops
    extra = _pv_recompute_flops(cfg, b, seq, m)
    assert want == 587202560 and extra == 8388608
    assert got.flops == want + extra
    # the same step on meta counts what it counts on the CPU
    meta = dryrun.count_train(cfg, ShapeSpec("t", seq, b, "train"), None, m)
    assert (meta.flops, meta.bytes) == (got.flops, got.bytes)


# ---------------------------------------------------------------------------
# the dry-run: depth extrapolation, collectives, records
# ---------------------------------------------------------------------------

def _deep(arch: str):
    """A smoke config with five repeats of its segment."""
    cfg = get_smoke_config(arch)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=5 * cfg.attn_every + 1)
    if cfg.n_experts:
        return dataclasses.replace(cfg, n_layers=cfg.first_k_dense + 5)
    return dataclasses.replace(cfg, n_layers=5)


def _same(a: op_cost.Cost, b: op_cost.Cost) -> None:
    for field in ("flops", "bytes", "ops", "coll_bytes", "alloc_bytes"):
        assert getattr(a, field) == getattr(b, field), field
    for field in ("flops_by_dtype", "kernels", "coll_counts"):
        x, y = getattr(a, field), getattr(b, field)
        assert {k: v for k, v in x.items() if v} == \
            {k: v for k, v in y.items() if v}, field


COUNTS = {
    "train": lambda cfg: dryrun.count_train(
        dryrun._train_cfg(cfg), SMOKE_TRAIN, None, 2),
    "prefill": lambda cfg: dryrun.count_prefill(
        dryrun._serve_cfg(cfg), SMOKE_PREFILL),
    "decode": lambda cfg: dryrun.count_decode(
        dryrun._serve_cfg(cfg), SMOKE_DECODE),
}


@pytest.mark.parametrize("kind", sorted(COUNTS))
@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v2-lite-16b",
                                  "zamba2-1.2b"])
def test_depth_extrapolation_is_exact(arch, kind):
    cfg = _deep(arch)
    reps, cut = dryrun.depth_cut(cfg)
    assert reps == 5 and cut(reps) == cfg
    count = COUNTS[kind]
    full, _ = dryrun.count_depth(cfg, count, full=True)
    got, depth = dryrun.count_depth(cfg, count)
    assert depth["extrapolated"] and depth["repeats"] == reps
    _same(got, full)
    assert full.flops > 0


def test_fsdp_step_collectives():
    """Each split leaf gathered whole once (all-gather of its bytes) and
    its gradient reduce-scattered (fp32: the step accumulates); each
    replicated leaf's gradient all-reduced; the batch's two leaves
    gathered."""
    cfg = get_smoke_config("yi-6b")
    mesh = make_test_mesh((2, 2), device="meta")
    b, seq = 4, 32
    cost = dryrun.count_train(cfg, ShapeSpec("t", seq, b, "train"), mesh, 2)
    schema = model_schema(cfg)
    leaves = tree_leaves(schema)
    split = [any(e is not None for e in s) for s in
             tree_leaves(spec_tree(schema, mesh))]
    nbytes = [int(np.prod(d.shape)) * d.dtype.itemsize for d in leaves]
    f32 = [int(np.prod(d.shape)) * 4 for d in leaves]
    batch = 2 * b * seq * 4
    want = {"all-gather": sum(split) + 2, "reduce-scatter": sum(split),
            "all-reduce": len(leaves) - sum(split)}
    assert {k: v for k, v in cost.coll_counts.items() if v} == \
        {k: v for k, v in want.items() if v}
    by = cost.coll_bytes_by_kind
    assert by["all-gather"] == sum(n for n, s in zip(nbytes, split) if s) \
        + batch
    assert by["reduce-scatter"] == sum(n for n, s in zip(f32, split) if s)
    assert by["all-reduce"] == 2 * sum(n for n, s in zip(f32, split)
                                       if not s)
    assert cost.coll_bytes == sum(by.values()) and cost.dcn_bytes == 0


JAX_KEYS = {"kind", "memory", "roofline", "collectives", "params",
            "active_params", "chips", "status", "compile_s", "arch",
            "shape", "mesh"}


@pytest.fixture(scope="module")
def yi_decode_record():
    return dryrun.lower_cell("yi-6b", "decode_32k", False)


def test_lower_cell_record_has_jax_keys(yi_decode_record):
    rec = yi_decode_record
    assert JAX_KEYS <= set(rec) and "xla_cost_analysis_raw" not in rec
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["device"] == "meta" and rec["depth"]["extrapolated"]
    m = rec["memory"]
    assert m["fits_80g_resident"] == (m["resident_bytes"] <= 80 * 10**9)
    assert m["peak_bytes"] >= m["resident_bytes"] > 0
    r = rec["roofline"]
    assert r["bottleneck"] == "memory" and r["flops_per_chip"] > 0
    assert r["model_flops"] == 2.0 * rec["active_params"] * 128
    json.dumps(rec)
    skip = dryrun.lower_cell("yi-6b", "long_500k", False)
    assert skip["status"] == "skip" and skip["skip_reason"] == skip["reason"]


def _hand_records():
    rows = []
    for i, (arch, shape, mesh) in enumerate([
            ("yi-6b", "train_4k", "single"), ("yi-6b", "train_4k", "multi"),
            ("mamba2-130m", "decode_32k", "single")]):
        fits = i != 1
        rows.append({
            "arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "chips": 256 if mesh == "single" else 512,
            "compile_s": 1.5 + i,
            "memory": {"resident_bytes": (3 + i) * 2**30,
                       "upper_bytes": (9 + i) * 2**30,
                       "fits_16g_resident": fits, "fits_16g": fits,
                       "fits_80g_resident": fits, "fits_80g": fits},
            "roofline": {"t_compute_s": 0.1 * (i + 1), "t_memory_s": 0.2,
                         "t_collective_s": 0.05, "bottleneck": "memory",
                         "model_flops": 1e15, "useful_flops_ratio": 0.5,
                         "roofline_fraction": 0.125},
            "collectives": {"total_bytes": 1e9 * (i + 1), "dcn_bytes": 0.0,
                            "bytes": {"all-gather": 6e8, "all-reduce": 4e8,
                                      "reduce-scatter": 1e8}}})
    rows.append({"arch": "yi-6b", "shape": "long_500k", "mesh": "single",
                 "status": "skip", "reason": "pure full-attention arch"})
    rows.append({"arch": "gemma2-27b", "shape": "train_4k", "mesh": "multi",
                 "status": "error", "returncode": 1})
    return rows


def test_report_tables_match_jax():
    rows = _hand_records()
    ok = [r for r in rows if r["status"] == "ok"]
    assert report.dryrun_table(rows) == \
        jreport.dryrun_table(rows).replace("fits 16G", "fits 80G")
    for mesh in ("single", "multi"):
        assert report.roofline_table(rows, mesh) == \
            jreport.roofline_table(rows, mesh)
    assert report.collectives_summary(ok) == jreport.collectives_summary(ok)


def test_report_runs_on_lower_cell_records(yi_decode_record, tmp_path):
    recs = [yi_decode_record,
            dryrun.lower_cell("yi-6b", "long_500k", False)]
    for i, rec in enumerate(recs):
        (tmp_path / f"r{i}.json").write_text(json.dumps(rec, default=str))
    text = report.report(report.load(str(tmp_path)))
    assert "1 counted, 1 documented skips, 0 errors" in text
    assert "| yi-6b | decode_32k | single | ok | 256 |" in text
    roofline = text.split("### Roofline (single-pod, 256 chips)")[1]
    row = next(r for r in roofline.splitlines()
               if r.startswith("| yi-6b | decode_32k |"))
    assert "| memory |" in row


def test_knn_cell_on_cpu_and_not_on_meta():
    rec = dryrun.lower_cell("knn-build", "knn_1m_256", False, device="cpu",
                            knn_n=2048, knn_shards=4)
    assert rec["status"] == "ok" and rec["device"] == "cpu"
    assert rec["kind"] == "knn" and rec["shards"] == 4
    assert rec["reduced"] == {"n": [1 << 20, 2048]} and rec["chips"] == 256
    c = rec["collectives"]
    assert c["counts"]["all-to-all"] > 0 and c["total_bytes"] > 0
    # the iteration's receivers reduce by the select kernel (one call a
    # shard); its pair distances are products the counter sees
    assert rec["counter"]["kernels"] == {"knn_join_select": 4}
    assert rec["counter"]["flops_by_dtype"]["fp32"] > 0
    assert rec["roofline"]["model_flops"] > 0
    # the cut corpus shows in the summary line and the report's tables
    assert "knn_1m_256 (n cut 1048576->2048) x single]" in \
        dryrun.summary_line(rec)
    table = report.dryrun_table([rec])
    assert "| knn-build | knn_1m_256 (n cut 1048576->2048) | single |" in table
    with pytest.raises(ValueError, match="cannot run on meta"):
        dryrun.lower_cell("knn-build", "knn_1m_256", False, device="meta")


def test_site_tallies_add_up_and_attr_ranks_them():
    """Every counted op and charge lands at one site: the sites' flops,
    bytes and ops sum to the totals; ``attr`` ranks them by bytes."""
    from repro_torch.launch import attr
    cfg = dryrun._train_cfg(get_smoke_config("yi-6b"))
    cost = dryrun.count_train(cfg, SMOKE_TRAIN, None, 2)
    sums = [sum(v[i] for v in cost.sites.values()) for i in range(3)]
    assert sums == [cost.flops, cost.bytes, cost.ops]
    assert any(s.endswith("(recompute)") for s in cost.sites)
    assert any(s.startswith("backward:") for s in cost.sites)
    rows = attr.attribute(cost, top=5)
    assert [r[0] for r in rows] == sorted((v[1] for v in cost.sites.values()),
                                          reverse=True)[:5]


def test_a_kernel_charge_lands_at_its_caller():
    """A ``kernels.ops`` call is charged once, at the port's function that
    called it: no site is the counter's hooks or ``ops`` itself."""
    from repro_torch import brute_force_knn
    x = _randn(64, 8)
    cost = op_cost.analyze(brute_force_knn, x, x, 4, device="cpu")
    assert cost.kernels == {"pairwise_sq_l2": 1}
    assert not any(s.startswith(("kernels.ops:", "core.cost:"))
                   for s in cost.sites)
    assert any(s.startswith("core.recall:") for s in cost.sites)


def test_perf_variants_are_jaxs():
    """The cells and variant names of JAX's ``perf.VARIANTS``, read from
    its source (importing it would set XLA_FLAGS)."""
    import ast
    from pathlib import Path

    import repro
    from repro_torch.launch import perf
    src = Path(repro.__file__).parent / "launch" / "perf.py"
    tree = ast.parse(src.read_text())
    node = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "VARIANTS")
    want = {cell.value: sorted(k.value for k in inner.keys)
            for cell, inner in zip(node.keys, node.values)}
    assert {c: sorted(v) for c, v in perf.VARIANTS.items()} == want
