"""kNN-LM serving — the paper's K-NN graph as a serving component
(src/repro/serve/knn_lm.py).

Datastore build: run the LM over a corpus, record (hidden state -> next
token) pairs, then build the K-NN GRAPH over the keys with NN-Descent
(core/). At decode time the query hidden state is answered by graph
search over that graph — NOT brute force — and the retrieved neighbours'
continuation tokens form a distance-weighted distribution interpolated
with the LM's:

    p(y) = (1 - lam) * p_LM(y) + lam * p_kNN(y)
    p_kNN(y) ∝ sum_{(k_i, v_i): v_i = y} exp(-d(q, k_i) / T)

``KNNDatastore.snapshot`` / ``restore`` persist the datastore in the
JAX package's snapshot format (core/persist.py), so a restart serves
without rebuilding the graph. ``MutableKNNDatastore`` is the growable
datastore: the online store (core/online.py) and a value array that
grows with it, so it absorbs (hidden state, next token) pairs during
decoding (the capture in serve/scheduler.py) and retires stale rows
without a rebuild.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import metric as metric_mod
from repro_torch.core import persist
from repro_torch.core.device import resolve_device
from repro_torch.core.graph_search import SearchConfig, graph_search
from repro_torch.core.nn_descent import DescentConfig, build_knn_graph
from repro_torch.core.online import (
    MutableKNNStore,
    OnlineConfig,
    knn_delete,
    knn_insert,
)
from repro_torch.core.quantize import QuantizedStore, quantize_corpus
from repro_torch.core.router import Router, RouterConfig, build_router


@dataclasses.dataclass
class KNNDatastore:
    keys: torch.Tensor          # (n, d) hidden states (transformed by metric)
    values: torch.Tensor        # (n,) next-token ids
    graph_idx: torch.Tensor     # (n, k) K-NN graph
    build_stats: dict
    # serving-search knobs (None = per-call default)
    search_cfg: SearchConfig | None = None
    # quantized mirror of ``keys`` for the two-stage scoring path (built
    # when ``build(precision=...)`` is quantized; the search re-ranks in
    # fp32, so retrieval distances stay exact)
    qstore: QuantizedStore | None = None
    # coarse routing layer: routed entry points for every search
    router: Router | None = None
    # the metric the datastore was built under; ``keys`` are stored
    # TRANSFORMED (core/metric.py) and every search runs under it
    metric: str = "l2"
    mips_m: float = 0.0

    @classmethod
    def build(cls, keys, values, *, k: int = 16,
              cfg: DescentConfig | None = None,
              precision: str = "f32",
              metric: str = "l2",
              router: RouterConfig | None = None,
              generator: torch.Generator | None = None,
              device=None):
        """Build the graph over ``keys`` (n, d) with NN-Descent, on
        ``device`` ("cuda" unless the caller asks for another).
        ``precision`` (f32 | int8 | bf16) precomputes the corpus mirror
        every ``knn_logits`` call then scores on; ``router`` builds the
        routing layer; ``metric`` transforms the keys once, here, and the
        graph, mirror and router are built over the transformed rows.
        ``generator`` seeds the build (and the router's sample)."""
        device = resolve_device(device, "KNNDatastore.build")
        cfg = cfg or DescentConfig(k=k, rho=1.0, max_iters=10)
        if cfg.metric != metric:
            cfg = dataclasses.replace(cfg, metric=metric)
        keys = torch.as_tensor(keys, dtype=torch.float32, device=device)
        values = torch.as_tensor(values, device=device)
        _, idx, st = build_knn_graph(keys, k=k, cfg=cfg,
                                     generator=generator, device=device)
        keys, mips_m = metric_mod.transform_corpus(keys, metric)
        return cls(
            keys=keys,
            values=values,
            graph_idx=idx,
            build_stats={"iters": st.iters, "dist_evals": st.dist_evals,
                         "reordered": st.reordered},
            qstore=(None if precision == "f32"
                    else quantize_corpus(keys, precision)),
            router=(None if router is None
                    else build_router(keys, cfg=router, device=device)),
            metric=metric,
            mips_m=mips_m,
        )

    def snapshot(self, directory: str, step: int = 0, *,
                 keep: int = 0) -> str:
        """Persist keys, values, graph (and the mirror and router) as a
        committed step (core/persist.py, kind ``knn_datastore``). Returns
        the step directory."""
        arrays, meta = persist.capture_datastore(self)
        return persist.write_snapshot(directory, step, arrays, meta,
                                      keep=keep)

    @classmethod
    def restore(cls, directory: str, step: int | None = None, *,
                device=None):
        """Reload a snapshotted datastore (the newest committed step when
        ``step`` is None) onto ``device``, "cuda" unless the caller asks
        otherwise: no NN-Descent, no re-quantization, no router refit;
        retrieval is bit-identical to the datastore that was saved."""
        step, arrays, manifest = persist.read_snapshot(directory, step)
        parts = persist.rebuild_datastore(arrays, manifest, device=device)
        return cls(build_stats={**manifest.get("build_stats", {}),
                                "restored_step": step}, **parts)


@dataclasses.dataclass
class MutableKNNDatastore:
    """Growable kNN-LM datastore: the online store (core/online.py) and a
    value array that grows in lockstep, so the datastore absorbs (hidden
    state, next token) pairs during decoding (the capture in
    serve/scheduler.py) and retires stale rows, without a graph rebuild.
    Value semantics, as the store's: every update returns a new datastore
    and writes new tensors, so a snapshot that holds the old ones (the
    async ``SnapshotWriter``) stays consistent."""

    store: MutableKNNStore
    values: torch.Tensor    # (cap,) next-token ids, row-aligned with store
    build_stats: dict
    # serving-search knobs (None = the store's defaults)
    search_cfg: SearchConfig | None = None
    # pending background fp32 load (quantized-first restore only; see
    # core/persist.Fp32Loader), resolved by ``finish_fp32``
    fp32_loader: Any = None

    @classmethod
    def build(cls, keys, values, *, k: int = 16,
              cfg: DescentConfig | None = None,
              online_cfg: OnlineConfig | None = None,
              frontier_chunk: int | None = None,
              q_block: int | None = None,
              precision: str | None = None,
              metric: str | None = None,
              router: RouterConfig | None = None,
              generator: torch.Generator | None = None,
              device=None):
        """Build the store over ``keys`` (n, d) on ``device`` ("cuda"
        unless the caller asks for another). ``frontier_chunk``,
        ``q_block``, ``precision``, ``metric`` and ``router`` override
        the fields of ``online_cfg`` (``chunk``, ``q_block``,
        ``precision``, ``metric``, ``router``): the insert frontier's
        padding quantum, the search's query block, the quantized mirror
        the searches score on (fp32 re-rank), the metric the store keeps
        its rows in, and the routing layer. ``generator`` seeds the
        build."""
        device = resolve_device(device, "MutableKNNDatastore.build")
        cfg = cfg or DescentConfig(k=k, rho=1.0, max_iters=10)
        online_cfg = online_cfg or OnlineConfig()
        for field, value in (("chunk", frontier_chunk), ("q_block", q_block),
                             ("precision", precision), ("metric", metric),
                             ("router", router)):
            if value is not None:
                online_cfg = dataclasses.replace(online_cfg,
                                                 **{field: value})
        store, st = MutableKNNStore.build(
            keys, k=k, cfg=online_cfg, descent=cfg, generator=generator,
            device=device)
        values = torch.as_tensor(values, device=store.x.device)
        vals = torch.zeros((store.capacity,), dtype=values.dtype,
                           device=store.x.device)
        vals[:values.shape[0]] = values
        return cls(store=store, values=vals,
                   build_stats={"iters": st.iters,
                                "dist_evals": st.dist_evals,
                                "reordered": st.reordered})

    def append(self, keys, values, *,
               generator: torch.Generator | None = None, entry=None,
               route_fill=None):
        """Insert (key, value) pairs; returns (datastore, insert stats).
        ``generator``, ``entry`` and ``route_fill`` go to ``knn_insert``.
        The values are written into a new tensor (grown with the store's
        capacity), never into the old one."""
        n0 = self.store.n
        store, stats = knn_insert(self.store, keys, generator=generator,
                                  entry=entry, route_fill=route_fill)
        vals = torch.zeros((store.capacity,), dtype=self.values.dtype,
                           device=self.values.device)
        vals[:self.values.shape[0]] = self.values
        vals[n0:store.n] = torch.as_tensor(values, dtype=vals.dtype,
                                           device=vals.device)
        return dataclasses.replace(self, store=store, values=vals), stats

    def delete(self, ids):
        store, stats = knn_delete(self.store, ids)
        return dataclasses.replace(self, store=store), stats

    def snapshot(self, directory: str, step: int | None = None, *,
                 keep: int = 0) -> str:
        """Persist the whole online store (rows, norms, lists, tombstones,
        mirror, router) and the row-aligned values as a committed step
        (core/persist.py; default step: the allocation high-water mark).
        Returns the step directory."""
        return persist.snapshot_store(
            self.store, directory, self.store.n if step is None else step,
            values=self.values, keep=keep)

    @classmethod
    def restore(cls, directory: str, step: int | None = None, *,
                quantized_first: bool = False, device=None):
        """Cold start from a snapshot (the newest committed step when
        ``step`` is None) onto ``device``, "cuda" unless the caller asks
        otherwise: searches, inserts and deletes are bit-identical to the
        saved datastore's. ``quantized_first`` serves from the quantized
        mirror at once while the fp32 rows load in the background;
        ``finish_fp32()`` swaps them in."""
        res = persist.restore_store(directory, step,
                                    quantized_first=quantized_first,
                                    device=device)
        values = res.values
        if values is None:
            values = torch.zeros((res.store.capacity,), dtype=torch.int32,
                                 device=res.store.x.device)
        return cls(store=res.store, values=values,
                   build_stats={"restored_step": res.step,
                                "live": res.manifest.get("live"),
                                "tombstones": res.manifest.get("tombstones")},
                   fp32_loader=res.fp32_loader)

    def finish_fp32(self):
        """Resolve a quantized-first restore: wait for the background fp32
        load and return a datastore whose store re-ranks on the exact
        rows. No-op without a pending loader."""
        if self.fp32_loader is None:
            return self
        store = self.fp32_loader.apply(self.store)
        return dataclasses.replace(self, store=store, fp32_loader=None)


def knn_logits(
    ds: KNNDatastore | MutableKNNDatastore,
    queries: torch.Tensor,   # (q, d) hidden states
    vocab: int,
    *,
    k: int = 8,
    temperature: float = 10.0,
    beam: int = 32,
    rounds: int = 24,
    generator: torch.Generator | None = None,
    cfg: SearchConfig | None = None,
    filter_ids: torch.Tensor | None = None,
    entry: torch.Tensor | None = None,
) -> torch.Tensor:
    """Graph-search retrieval -> (q, vocab) log-probabilities, on the
    datastore's device. A ``MutableKNNDatastore`` searches through its
    store (``store.search``), whose tombstoned rows are never returned;
    its values are gathered at capacity size.

    ``generator`` seeds the search entry points (a serving loop should
    vary it); without one, entries derive from the query batch content.
    ``entry`` (shared (e,) or per-query (q, e) ids) replaces the draw.
    ``cfg`` (or the datastore's ``search_cfg``) selects the search knobs;
    a datastore with a quantized mirror scores on it at the call's
    beam / rounds. The search always runs under the build metric.
    ``filter_ids`` restricts retrieval to admitted rows ((n,) or (q, n)
    bool); filtered rows contribute zero mass. A row with no valid hit
    degrades to the flat log(1e-20) floor instead of NaN."""
    cfg = cfg or ds.search_cfg
    if isinstance(ds, MutableKNNDatastore):
        # the store runs every search under its own metric
        dev = ds.store.x.device
        dist, idx = ds.store.search(queries, k_out=k, beam=beam,
                                    rounds=rounds, generator=generator,
                                    cfg=cfg, filter_ids=filter_ids,
                                    entry=entry)
    else:
        if cfg is None and ds.qstore is not None:
            cfg = SearchConfig(beam=beam, rounds=rounds,
                               precision=ds.qstore.mode)
        if cfg is None:
            cfg = SearchConfig(beam=beam, rounds=rounds, metric=ds.metric)
        elif cfg.metric != ds.metric:
            cfg = dataclasses.replace(cfg, metric=ds.metric)
        dev = ds.keys.device
        dist, idx = graph_search(ds.keys, ds.graph_idx, queries, k_out=k,
                                 beam=beam, rounds=rounds, entry=entry,
                                 generator=generator, cfg=cfg,
                                 qstore=ds.qstore, router=ds.router,
                                 filter_ids=filter_ids, device=dev)
    valid = idx >= 0
    w = torch.softmax(torch.where(valid, -dist / temperature, -torch.inf),
                      dim=-1)                                # (q, k)
    w = torch.where(valid & valid.any(dim=-1, keepdim=True), w, 0.0)
    vals = ds.values[idx.long().clamp(0, ds.values.shape[0] - 1)].long()
    probs = torch.zeros((idx.shape[0], vocab), device=dev)
    probs.scatter_add_(1, vals, w)
    return torch.log(probs.clamp_min(1e-20))


def interpolate(lm_logits: torch.Tensor, knn_logp: torch.Tensor,
                lam: float = 0.25) -> torch.Tensor:
    """log[(1-lam) p_LM + lam p_kNN]."""
    lm_logp = torch.log_softmax(lm_logits.float(), dim=-1)
    return torch.logaddexp(lm_logp + math.log1p(-lam),
                           knn_logp + math.log(lam))
