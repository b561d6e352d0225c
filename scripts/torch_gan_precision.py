#!/usr/bin/env python3
"""Where the port's f32 and bf16 GAN steps part from an f64 one.

One step of the augmenter GAN at full width (``AugmenterConfig()``:
D=5032, n_dim 500, noise 50, latent 10; ``DiscriminatorConfig(5032)``) on
the first ``--rows`` training cells of the hard synthetic dataset
(data_seed 3), from one state and one explicit ``GanNoise``, in f64 on the
device (the reference: ``cast_gan_state``, the loss views kept f64), in
f32 and bf16 on the device and in f32, f64 and bf16 on the CPU.  Prints,
MSE and ZINB, for each pair of ``PAIRS`` (a run against its reference):

  * the f32 products' error against f64 (the TF32 switch read back);
  * per batch norm of the augmenter's noise-free forward, with the
    reconstruction MSE's gradient taken back through it, the f32 error
    against the device's f64 (device and CPU) of the norm's input, its
    output and the gradients at both, the units whose sign differs at the
    norm's output, the smallest batch variance and the largest
    1/sqrt(var + eps), and the output ReLU's units on in one and off in the
    other;
  * per gradient leaf, max |Δ| / max |ref| and ‖Δ‖ / ‖ref‖, the biases
    that feed a batch norm apart (their true gradient is 0);
  * after Adam's first step, the share of parameters beyond 1e-5 of the
    reference's (those biases left out), and the reference gradient's size
    where they are.

    python3 scripts/torch_gan_precision.py [--device cuda] [--rows 2000]
        [--out results/gan_precision.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _HERE)

import chip_smoke as cs  # noqa: E402  (its noise, its list of biases)

LR = cs.LR
# (run, reference) pairs compared leaf by leaf
PAIRS = (("dev f32", "dev f64"), ("cpu f32", "dev f64"),
         ("cpu f64", "dev f64"), ("dev bf16", "dev f64"),
         ("dev bf16", "dev f32"), ("dev bf16", "cpu bf16"))


def _errs(torch, got, ref):
    d = (got.double() - ref.double())
    r = ref.double()
    return (float(d.abs().max() / r.abs().max().clamp_min(1e-300)),
            float(d.norm() / r.norm().clamp_min(1e-300)))


def _named(tree, prefix):
    return [f"{prefix}.{n}.{k}" for n in sorted(tree) for k in sorted(tree[n])
            if tree[n][k] is not None]


def run_mode(torch, mode, x, dev, rows):
    import dvae_tpu_torch.augment.augmenter as taug
    import dvae_tpu_torch.augment.train as gt

    class Recording(gt.GatedAdam):
        def update(self, grads, state, params, gate=None):
            self.grads = [t.detach().double().cpu() for t in grads]
            return super().update(grads, state, params, gate)

    a_cfg = taug.AugmenterConfig(input_dim=x.shape[1],
                                 n_zim=2 if mode == "ZINB" else 1)
    d_cfg = taug.DiscriminatorConfig(x.shape[1])
    cs.DEV = dev
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 11)
    noise = cs.gan_noise(torch, g, a_cfg, rows, mode == "ZINB")
    runs = {}
    for label, where, dtype, bf16 in (
            ("dev f64", dev, torch.float64, False),
            ("dev f32", dev, torch.float32, False),
            ("dev bf16", dev, torch.float32, True),
            ("cpu f32", "cpu", torch.float32, False),
            ("cpu f64", "cpu", torch.float64, False),
            ("cpu bf16", "cpu", torch.float32, True)):
        tx = Recording(LR), Recording(LR)
        state = gt.cast_gan_state(
            gt.init_gan_state(0, a_cfg, d_cfg, *tx, where), dtype)
        step = gt.make_gan_step(a_cfg, d_cfg, *tx, mode=mode, bf16=bf16)
        state, m = step(state, x.to(where, dtype),
                        cs._noise_on(noise, where, dtype))
        runs[label] = dict(
            grads=tx[0].grads + tx[1].grads,
            params=[t.detach().double().cpu() for t in
                    gt.tree_leaves(state.a_params)
                    + gt.tree_leaves(state.d_params)],
            metrics={k: float(v) for k, v in m._asdict().items()})
        names = (_named(state.a_params, "a") + _named(state.d_params, "d"))
    bn_fed = [nm.endswith(".b") and nm.split(".")[1] in cs.GAN_BN_FED
              for nm in names]
    out = {"metrics": {k: v["metrics"] for k, v in runs.items()}}
    for label, against in PAIRS:
        r, ref = runs[label], runs[against]
        label = f"{label} vs {against}"
        leaves, fed = [], []
        far = n = 0
        g_far = []
        for nm, is_fed, u, v, pu, pv in zip(names, bn_fed, r["grads"],
                                            ref["grads"], r["params"],
                                            ref["params"]):
            mx, nr = _errs(torch, u, v)
            (fed if is_fed else leaves).append(
                (nm, mx, nr, float(v.abs().max())))
            if not is_fed:
                beyond = (pu - pv).abs() > 1e-5
                far += int(beyond.sum())
                n += beyond.numel()
                if beyond.any():
                    g_far.append(v[beyond].abs())
        g_far = (torch.cat(g_far) if g_far
                 else torch.zeros(1, dtype=torch.float64))
        gmax = max(float(v.abs().max())
                   for v, f in zip(ref["grads"], bn_fed) if not f)
        out[label] = {
            "leaves": leaves,
            "worst_max_rel": sorted(leaves, key=lambda t: -t[1])[:4],
            "worst_norm_rel": sorted(leaves, key=lambda t: -t[2])[:4],
            "bn_fed_bias_grad_max": max(t[3] for t in fed),
            "weight_grad_max": gmax,
            "share_beyond_1e-5": far / n,
            "beyond": far, "entries": n,
            "ref_grad_where_beyond_median": float(g_far.median()),
            "ref_grad_where_beyond_max": float(g_far.max())}
        w = out[label]
        print(f"  {mode} {label}: losses {r['metrics']}")
        print(f"    gradient, worst max|Δ|/max|ref|: "
              + ", ".join(f"{a} {b:.2e}" for a, b, _, _ in
                          w["worst_max_rel"])
              + "; worst ‖Δ‖/‖ref‖: "
              + ", ".join(f"{a} {c:.2e}" for a, _, c, _ in
                          w["worst_norm_rel"]))
        print(f"    after Adam: {far} of {n} entries beyond 1e-5 "
              f"({far / n:.4%}), the reference gradient there median "
              f"{w['ref_grad_where_beyond_median']:.2e}, max "
              f"{w['ref_grad_where_beyond_max']:.2e} (largest gradient "
              f"{gmax:.2e}; batch-norm-fed biases' largest "
              f"{w['bn_fed_bias_grad_max']:.2e})")
    out["by_norm"] = by_norm(torch, a_cfg, d_cfg, x, noise, dev, mode)
    return out


def by_norm(torch, a_cfg, d_cfg, x, noise, dev, mode):
    """Every batch norm of the augmenter's noise-free forward (the one the
    augmenter's gradient flows through), with the reconstruction MSE's
    gradient taken back through it: at each norm the f32 error against
    the device's f64 of its input, its output and the gradients at both,
    on the device and on the CPU."""
    import dvae_tpu_torch.augment.augmenter as taug
    import dvae_tpu_torch.augment.train as gt
    rec, real_bn = [], taug._bn

    def bn(h, stats, train, eps=taug.BN_EPS, momentum=taug.BN_MOMENTUM):
        y, new = real_bn(h, stats, train, eps, momentum)
        h.retain_grad()
        y.retain_grad()
        rec.append((h, y, eps))
        return y, new

    def run(where, dtype):
        rec.clear()
        st = gt.cast_gan_state(gt.init_gan_state(
            0, a_cfg, d_cfg, gt.GatedAdam(LR), gt.GatedAdam(LR), where),
            dtype)
        p = {n: {k: None if v is None else v.requires_grad_()
                 for k, v in layer.items()} for n, layer in
             st.a_params.items()}
        xx = x.to(where, dtype)
        _, fake, _ = taug.apply_augmenter(
            p, st.a_bn, a_cfg, xx, train=True, noise=False,
            draws=cs._noise_on(noise, where, dtype).fake2)
        fake = fake[..., :xx.shape[1]]
        if mode == "ZINB":
            fake = fake * gt._binarize(xx, gt.DATA_BIN_EPS)
        ((fake - xx) ** 2).mean().backward()
        return [(h.detach().double().cpu(), y.detach().double().cpu(),
                 h.grad.double().cpu(), y.grad.double().cpu(), eps)
                for h, y, eps in rec], fake.detach().cpu() > 0

    taug._bn = bn
    try:
        with torch.enable_grad():
            ref, on64 = run(dev, torch.float64)
            runs, on = {}, {}
            for label, where in (("dev f32", dev), ("cpu f32", "cpu")):
                runs[label], on[label] = run(where, torch.float32)
    finally:
        taug._bn = real_bn
    rows = []
    print(f"  {mode} augmenter forward and backward (noise off), at each "
          "batch norm ‖Δ‖/‖ref‖ against dev f64 of input, output, their "
          "gradients:")
    for i, (h64, y64, gh64, gy64, eps) in enumerate(ref):
        var = h64.var(dim=0, unbiased=False)
        row = {"call": i, "width": h64.shape[-1],
               "var_min": float(var.min()),
               "rstd_max": float((var.min() + eps) ** -0.5)}
        for label, r in runs.items():
            h, y, gh, gy, _ = r[i]
            row[label] = [_errs(torch, u, v)[1] for u, v in
                          ((h, h64), (y, y64), (gy, gy64), (gh, gh64))]
            row[label + " sign changes"] = int(((y > 0) != (y64 > 0)).sum())
        rows.append(row)
        print(f"    norm {i:2d} width {row['width']:5d}: "
              + "; ".join(f"{k} " + " ".join(f"{e:.1e}" for e in row[k])
                          + f" ({row[k + ' sign changes']} signs)"
                          for k in runs)
              + f"; min batch var {row['var_min']:.3e}, max "
              f"1/sqrt(var+eps) {row['rstd_max']:.3e}")
    out = {"norms": rows}
    for label in runs:
        out[label + " output units switched"] = int((on[label]
                                                      != on64).sum())
    print(f"    the output ReLU's units on in one and off in the other: "
          + ", ".join(f"{k} {v}" for k, v in out.items() if k != "norms")
          + f" of {on64.numel()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--out", default=os.path.join("results",
                                                  "gan_precision.json"))
    a = ap.parse_args(argv)
    import torch

    from dvae_tpu_torch.data.pipeline import stratified_split_indices
    from dvae_tpu_torch.examples import hard_synthetic
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = hard_synthetic._dataset(3, a.device)
    tr, _ = stratified_split_indices(ds.cluster_label, 0.9, 3)
    x = torch.from_numpy(ds.log1p[tr[:a.rows]]).to(a.device)
    report = {"rows": a.rows, "device": a.device,
              "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    if a.device != "cpu":
        import subprocess
        report["card"] = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"card: {report['card']}")
    w = torch.randn((x.shape[1], x.shape[1] // 5),
                    generator=torch.Generator().manual_seed(0)) / 71.0
    for where in dict.fromkeys((a.device, "cpu")):
        xs, ws = x.to(where), w.to(where)
        report[f"matmul_norm_rel_{where}"] = _errs(
            torch, xs @ ws, xs.double() @ ws.double())[1]
    print(f"f32 product ({x.shape[0]} x {x.shape[1]} @ {tuple(w.shape)}) "
          f"vs f64, ‖Δ‖/‖ref‖: "
          + ", ".join(f"{k[16:]} {v:.2e}" for k, v in report.items()
                      if k.startswith("matmul"))
          + f"; allow_tf32 {report['allow_tf32']}")
    for mode in ("MSE", "ZINB"):
        report[mode] = run_mode(torch, mode, x, a.device, a.rows)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
