"""Traffic kind ``serve_closed_loop``: one client labelling slices of an
atlas that lives on the card, one ``CplMixVAE.eval_model`` call at a time.

Parameters: ``n_atlas`` cells of kind ``data`` (see ``core/data.py``),
made on the card at set-up; request sizes from a fixed grid of
``n_sizes`` sizes spaced evenly in log between ``min_cells`` and
``max_cells``, every seed sending the same sizes: each cycle of the plan
is the grid in an order drawn from the seed; offsets uniform over the
atlas; ``warm_sizes`` warm up before the window; ``sample`` requests of
the first ``sample_from`` (the largest size among them) are kept and
compared with the reference once the window has closed; ``trace_requests``
run profiled after the window with ``--trace 1``.

A request's latency runs from the call until its numpy results are back;
the window runs requests until ``--seconds`` have passed and counts every
request it started.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.core import data, program, trace
from portbench.core.compare import ServeErrors, consensus
from portbench.core.harness import Result
from portbench.core.weights import load_into, make_bn, make_params
from portbench.reference import model as ref
from portbench.reference.draws import eval_noise


def size_grid(p: dict) -> np.ndarray:
    return np.round(np.exp(np.linspace(np.log(p["min_cells"]),
                                       np.log(p["max_cells"]),
                                       p["n_sizes"]))).astype(np.int64)


def plan(p: dict, seed: int, cycles: int = 200):
    """[(offset, size)]: ``cycles`` cycles of the size grid, each in an
    order drawn from ``seed``, each request at a uniform offset."""
    rng = np.random.default_rng(seed)
    grid = size_grid(p)
    sizes = np.concatenate([rng.permutation(grid) for _ in range(cycles)])
    offs = (rng.random(sizes.size) * (p["n_atlas"] - sizes + 1)).astype(
        np.int64)
    return list(zip(offs.tolist(), sizes.tolist()))


def sample_indices(reqs, p: dict, seed: int) -> list:
    """``sample`` request indices among the first ``sample_from``, drawn
    from ``seed``, the first request of the largest size among them."""
    head = reqs[:p["sample_from"]]
    big = int(np.argmax([n for _, n in head]))
    rng = np.random.default_rng(seed)
    rest = [i for i in range(len(head)) if i != big]
    pick = rng.choice(rest, size=min(p["sample"] - 1, len(rest)),
                      replace=False)
    return sorted({big, *pick.tolist()})


def batches(n: int, B: int) -> list:
    return [B] * (n // B) + ([n % B] if n % B else [])


def setup(ctx) -> dict:
    """The atlas, weights and batch-norm statistics from the seed, the
    server (``CplMixVAE`` through ``init_model``) holding them, the request
    plan and the sampled requests."""
    m, p, dev = ctx.model, ctx.params, ctx.device
    atlas = data.make(p["n_atlas"], m["input_dim"], ctx.seed_for("data"),
                      p["data"], dev)
    weights = make_params(m, ctx.seed_for("weights"), dev)
    bn = make_bn(m, ctx.seed_for("bn"), dev)
    server = program.build(ctx.config, dev, ctx.seed)
    load_into(server.state.params, weights)
    load_into(server.state.bn, bn)
    reqs = plan(p, ctx.seed_for("plan"))
    return {"atlas": atlas, "weights": weights, "bn": bn, "server": server,
            "reqs": reqs,
            "keep": set(sample_indices(reqs, p, ctx.seed_for("sample")))}


def as_served(want: dict, m: dict) -> dict:
    """A reference evaluation in the form ``eval_model`` returns."""
    lab = want["lab"].cpu().numpy()
    return {"c_prob": want["c"].cpu().numpy(),
            "state_mu": want["s_mean"].cpu().numpy(),
            "state_logvar": want["s_logvar"].cpu().numpy(),
            "x_low": want["x_low"].cpu().numpy(), "pred_label": lab,
            "total_loss": want["total_loss"],
            "total_loss_rec": want["total_loss_rec"].cpu().numpy(),
            "consensus": consensus(lab, m["n_categories"]),
            "mask": np.ones(m["n_categories"], np.float32)}


def reference(ctx, s: dict, j: int, mode: str = "highest") -> dict:
    """The reference's evaluation of request ``j`` in precision ``mode``."""
    off, n = s["reqs"][j % len(s["reqs"])]
    with ref.precision(mode):
        return ref.evaluate(s["weights"], s["bn"], s["atlas"][off:off + n],
                            ctx.model, ctx.train["batch_size"],
                            eval_noise(ctx.seed, ctx.model, ctx.device))


def judge(ctx, s: dict, kept: dict) -> dict:
    """The compared numbers of the served requests ``kept`` ({index:
    eval_model's result})."""
    errs = ServeErrors()
    for j in sorted(kept):
        errs.add(kept[j], reference(ctx, s, j), ctx.model)
    out = errs.numbers()
    out["compared_requests"] = errs.requests
    return out


def run(ctx) -> Result:
    p = ctx.params
    dev, B = ctx.device, ctx.train["batch_size"]
    res = Result()
    s = setup(ctx)
    atlas, server, reqs, keep = s["atlas"], s["server"], s["reqs"], s["keep"]

    for n in p["warm_sizes"]:
        server.eval_model(atlas[:n], batch_size=B)
    res.e2e["setup_s"] = time.perf_counter() - ctx.t_start

    kept, lat, cells, failed = {}, [], 0, 0
    t0 = time.perf_counter()
    i = 0
    while True:
        off, n = reqs[i % len(reqs)]
        ts = time.perf_counter()
        try:
            with trace.span("request"):
                out = server.eval_model(atlas[off:off + n], batch_size=B)
        except RuntimeError as e:
            failed += 1
            res.notes.append(f"request {i} ({n} cells) failed: {e}")
            out = None
        lat.append(time.perf_counter() - ts)
        if out is not None:
            cells += n
            if i in keep:
                kept[i] = out
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    wall = time.perf_counter() - t0
    lat_ms = 1e3 * np.asarray(lat)
    res.e2e["serve_cells_per_s"] = cells / wall
    res.e2e["serve_p95_ms"] = float(np.percentile(lat_ms, 95))
    res.attempted, res.failed = i, failed
    res.host.update({"window_s": wall, "served_cells": cells,
                     "requests": i})
    res.notes.append(f"requests {i}, latency ms median "
                     f"{np.median(lat_ms):.3f} p95 "
                     f"{res.e2e['serve_p95_ms']:.3f} max {lat_ms.max():.3f}")

    if ctx.trace:
        sizes = []
        with trace.profiled() as prof:
            for j in range(i, i + p["trace_requests"]):
                off, n = reqs[j % len(reqs)]
                with trace.span("request"):
                    server.eval_model(atlas[off:off + n], batch_size=B)
                sizes.append(n)
        res.slice = prof.slice
        res.host["slice_served_cells"] = sum(sizes)
        res.calls["request"] = [b for n in sizes for b in batches(n, B)]

    if dev.type == "cuda":
        res.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del server, s["server"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    res.numbers = judge(ctx, s, kept)
    if res.numbers["compared_requests"] == 0:
        res.failed += 1
    return res
