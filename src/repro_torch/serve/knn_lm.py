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
without rebuilding the graph. Not ported yet: the growable
``MutableKNNDatastore`` (ROADMAP.md, Queue 1, item 5).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import metric as metric_mod
from repro_torch.core import persist
from repro_torch.core.device import resolve_device
from repro_torch.core.graph_search import SearchConfig, graph_search
from repro_torch.core.nn_descent import DescentConfig, build_knn_graph
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


def knn_logits(
    ds: KNNDatastore,
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
    datastore's device.

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
                             generator=generator, cfg=cfg, qstore=ds.qstore,
                             router=ds.router, filter_ids=filter_ids,
                             device=dev)
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
