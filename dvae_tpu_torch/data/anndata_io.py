"""Cell×gene datasets of the PyTorch port.

Counterpart of dvae_tpu/data/anndata_io.py: ``CellDataset``;
``read_h5ad_arrays`` (:147) with its helpers, ``write_h5ad`` (:247),
``write_h5ad_legacy07`` (:301) and ``load_data`` (:351), which read and
write ``.h5ad`` files with h5py alone (the anndata>=0.8 layout, the
anndata-0.7.x one with its object-reference categoricals, dense, CSR or
CSC ``X``), importing h5py inside the functions: the card's machine does
not carry it; ``synthetic_dataset`` (:533-561), number for number the same
data from the same seed; and ``hard_synthetic_dataset`` (:420-530), whose
programs, assignments and labels are the JAX package's number for number
while its ZINB counts come from the port's own sampler (the same
distributions, another bitstream).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - np.max(x, axis=axis, keepdims=True)
    e = np.exp(x)
    return e / np.sum(e, axis=axis, keepdims=True)


@dataclass
class CellDataset:
    """A cell×gene dataset with cluster annotations.

    ``log1p`` (N, D) float32 expression; ``gene_id`` (D,); ``cluster_label``
    (N,) strings; ``cluster_id`` (N,) 1-based ids; ``c_onehot`` (N, K);
    ``c_p`` (N, K) softened prior softmax((onehot+eps)/tau); ``n_type`` K.
    """

    log1p: np.ndarray
    gene_id: np.ndarray
    cluster_label: np.ndarray
    cluster_id: np.ndarray
    c_onehot: np.ndarray
    c_p: np.ndarray
    n_type: int
    obs: dict = field(default_factory=dict)

    @property
    def n_cells(self) -> int:
        return int(self.log1p.shape[0])

    @property
    def n_genes(self) -> int:
        return int(self.log1p.shape[1])

    def as_dict(self) -> dict:
        """The reference's dict view (mmidas/utils/dataloader.py:13-70)."""
        d = dict(self.obs)
        d.update(
            log1p=self.log1p, gene_id=self.gene_id,
            cluster_label=self.cluster_label, cluster_id=self.cluster_id,
            c_onehot=self.c_onehot, c_p=self.c_p, n_type=self.n_type,
        )
        return d


def _encode_labels(labels: np.ndarray, eps: float, tau: float):
    """Dense 1-based ids, one-hot and softened prior from string labels."""
    uniq, int_enc = np.unique(labels, return_inverse=True)
    cluster_id = (int_enc + 1).astype(np.float64)
    K = len(uniq)
    onehot = np.zeros((len(labels), K), dtype=np.float64)
    onehot[np.arange(len(labels)), int_enc] = 1.0
    c_p = _softmax((onehot + eps) / tau, axis=1)
    return cluster_id, onehot, c_p, K


def _h5_str(v):
    return v.decode() if isinstance(v, bytes) else v


def _h5_decode(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind in ("S", "O"):
        return np.array([_h5_str(x) for x in a.tolist()])
    return a


def _codes_to_labels(codes: np.ndarray, cats: np.ndarray) -> np.ndarray:
    out = np.full(codes.shape, "nan", dtype=object)
    valid = codes >= 0
    out[valid] = cats[codes[valid]]
    return np.array(out.tolist())


def _h5_column(node):
    """An obs/var column: plain dataset, the modern AnnData categorical
    group ({codes, categories}), or the anndata-0.7.x encoding (an int
    codes dataset whose ``categories`` attr is an object reference into
    the sibling ``__categories`` group); None for unsupported elements."""
    import h5py
    if isinstance(node, h5py.Dataset):
        ref = node.attrs.get("categories")
        if isinstance(ref, h5py.Reference):      # 0.7.x vintage
            cats = _h5_decode(node.file[ref][()])
            return _codes_to_labels(np.asarray(node[()]), cats)
        return _h5_decode(node[()])
    if "categories" in node and "codes" in node:
        return _codes_to_labels(np.asarray(node["codes"][()]),
                                _h5_decode(node["categories"][()]))
    return None


def _h5_frame(g):
    """(index, columns dict) from an AnnData obs/var HDF5 node.  Handles
    the modern group layout (one child per column, ``_index`` attr) and
    the legacy compound-dtype dataset (anndata < 0.7)."""
    import h5py
    if isinstance(g, h5py.Dataset):            # legacy structured array
        rec = g[()]
        cols = {name: _h5_decode(rec[name]) for name in rec.dtype.names}
        # pop sequentially: the one-liner pop("index", pop("_index", None))
        # evaluates the inner pop eagerly and would drop a '_index' column
        # from a frame that also has an 'index' column
        idx = cols.pop("index", None)
        if idx is None:
            idx = cols.pop("_index", None)
        return idx, cols
    idx_name = _h5_str(g.attrs.get("_index", "index"))
    cols = {}
    for k in g.keys():
        if k == "__categories":              # 0.7.x side table, not a column
            continue
        v = _h5_column(g[k])
        if v is not None:
            cols[k] = v
    return cols.pop(idx_name, None), cols


def read_h5ad_arrays(path: str):
    """(X dense f32, var index, obs columns dict) from an .h5ad file using
    h5py only — no anndata dependency.  Supports dense X and the
    CSR/CSC sparse group encoding (``data``/``indices``/``indptr`` +
    ``shape`` attr), modern per-column obs groups (incl. categoricals),
    and the legacy compound-dtype obs dataset."""
    import h5py

    with h5py.File(path, "r") as f:
        Xn = f["X"]
        if isinstance(Xn, h5py.Group):
            enc = _h5_str(Xn.attrs.get(
                "encoding-type", Xn.attrs.get("h5sparse_format", "csr")))
            raw_shape = Xn.attrs.get("shape", Xn.attrs.get("h5sparse_shape"))
            if raw_shape is None:
                raise ValueError(
                    f"{path}: sparse X group has neither a 'shape' nor an "
                    "'h5sparse_shape' attribute — unsupported .h5ad sparse "
                    "encoding (install anndata to read this file)")
            shape = tuple(int(s) for s in np.asarray(raw_shape))
            data = np.asarray(Xn["data"], dtype=np.float32)
            indices = np.asarray(Xn["indices"])
            indptr = np.asarray(Xn["indptr"])
            X = np.zeros(shape, np.float32)
            major = np.repeat(np.arange(len(indptr) - 1),
                              np.diff(indptr))
            if enc.startswith("csr"):
                X[major, indices] = data
            else:                               # csc
                X[indices, major] = data
        else:
            X = np.asarray(Xn[()], dtype=np.float32)
        var_index, _ = _h5_frame(f["var"])
        obs_index, obs = _h5_frame(f["obs"])
        if obs_index is not None:
            obs.setdefault("cell_id", obs_index)
    return X, np.asarray(var_index), obs


def _h5_strings(parent, name: str, values) -> None:
    """A variable-length UTF-8 string dataset with the AnnData
    ``string-array`` element encoding (anndata on-disk spec v0.1:
    fileformat-prose — every element carries encoding-type/-version)."""
    import h5py

    d = parent.create_dataset(
        name, data=np.asarray(values, dtype=object),
        dtype=h5py.string_dtype(encoding="utf-8"))
    d.attrs["encoding-type"] = "string-array"
    d.attrs["encoding-version"] = "0.2.0"


def _h5_array(parent, name: str, values) -> None:
    d = parent.create_dataset(name, data=np.asarray(values))
    d.attrs["encoding-type"] = "array"
    d.attrs["encoding-version"] = "0.2.0"


def _h5_categorical(parent, name: str, values) -> None:
    """A pandas-categorical column in the modern AnnData group layout:
    {codes, categories} + ``ordered`` attr (encoding ``categorical``
    v0.2.0) — how anndata>=0.8 writes ``obs['cluster']``."""
    cats, codes = np.unique(np.asarray(values, dtype=str),
                            return_inverse=True)
    g = parent.create_group(name)
    g.attrs["encoding-type"] = "categorical"
    g.attrs["encoding-version"] = "0.2.0"
    g.attrs["ordered"] = False
    # pandas sizes codes to the category count: int8 up to 127 categories
    dt = np.int8 if len(cats) < 128 else np.int32
    _h5_array(g, "codes", codes.astype(dt))
    _h5_strings(g, "categories", cats)


def _h5_dataframe(parent, name: str, index_name: str, index,
                  columns: dict, categorical=()) -> None:
    """A DataFrame group per the AnnData spec: ``_index``/``column-order``
    attrs, one encoded element per column."""
    import h5py

    g = parent.create_group(name)
    g.attrs["encoding-type"] = "dataframe"
    g.attrs["encoding-version"] = "0.2.0"
    g.attrs["_index"] = index_name
    # vlen-utf8 dtype explicitly: an EMPTY column list (a var frame with
    # only its index) has object dtype h5py cannot infer a type for
    g.attrs.create("column-order",
                   data=np.asarray(list(columns), dtype=object),
                   dtype=h5py.string_dtype(encoding="utf-8"))
    _h5_strings(g, index_name, index)
    for col, vals in columns.items():
        vals = np.asarray(vals)
        if col in categorical:
            _h5_categorical(g, col, vals)
        elif vals.dtype.kind in ("U", "S", "O"):
            _h5_strings(g, col, vals)
        else:
            _h5_array(g, col, vals)


def write_h5ad(path: str, X: np.ndarray, gene_id, cluster_label,
               obs: Optional[dict] = None, cell_id=None,
               sparse: Optional[str] = None,
               categorical: Sequence[str] = ("cluster",)) -> str:
    """Write an .h5ad with h5py only, in the anndata>=0.8 on-disk layout.

    The inverse of ``read_h5ad_arrays``, for machines without anndata.
    Every element carries the spec's
    ``encoding-type``/``encoding-version`` attributes — files round-trip
    through ``anndata.read_h5ad`` unchanged where anndata IS installed
    (the layout is the one its writer produces for a dense-or-CSR ``X``,
    string var index, and categorical/str/numeric obs columns).

    ``sparse``: None = dense ``X`` dataset; "csr"/"csc" = the sparse group
    encoding ({data, indices, indptr} + shape attr).  Reference input
    contract: mmidas/utils/dataloader.py:13-70 expects ``obs['cluster']``
    and ``var.index`` gene names.
    """
    import h5py

    X = np.asarray(X, dtype=np.float32)
    obs_cols = {"cluster": np.asarray(cluster_label, dtype=str)}
    for k, v in (obs or {}).items():
        obs_cols[k] = np.asarray(v)
    n, d = X.shape
    if cell_id is None:
        cell_id = np.array([f"cell_{i}" for i in range(n)])
    with h5py.File(path, "w") as f:
        f.attrs["encoding-type"] = "anndata"
        f.attrs["encoding-version"] = "0.1.0"
        if sparse is None:
            _h5_array(f, "X", X)
        else:
            import scipy.sparse as sp

            m = (sp.csr_matrix if sparse == "csr" else sp.csc_matrix)(X)
            g = f.create_group("X")
            g.attrs["encoding-type"] = f"{sparse}_matrix"
            g.attrs["encoding-version"] = "0.1.0"
            g.attrs["shape"] = np.asarray([n, d], dtype=np.int64)
            _h5_array(g, "data", m.data.astype(np.float32))
            _h5_array(g, "indices", m.indices.astype(np.int32))
            _h5_array(g, "indptr", m.indptr.astype(np.int64))
        _h5_dataframe(f, "obs", "_index", np.asarray(cell_id, dtype=str),
                      obs_cols, categorical=categorical)
        _h5_dataframe(f, "var", "_index", np.asarray(gene_id, dtype=str), {})
        for name in ("uns", "obsm", "varm", "obsp", "varp", "layers"):
            g = f.create_group(name)
            g.attrs["encoding-type"] = "dict"
            g.attrs["encoding-version"] = "0.1.0"
    return path


def write_h5ad_legacy07(path: str, X: np.ndarray, gene_id, cluster_label,
                        obs: Optional[dict] = None,
                        sparse: bool = False) -> str:
    """Write the anndata-0.7.x vintage layout: per-column obs datasets
    whose categorical columns are int-code datasets with a ``categories``
    object-reference attr into the sibling ``obs/__categories`` table, and
    (optionally) the h5sparse X group (``h5sparse_format``/``h5sparse_shape``
    attrs).  Real Allen-atlas era files (the reference's
    Mouse_ALM-VISp_cpm.h5ad vintage) use this layout — the reader must
    keep consuming it."""
    import h5py

    X = np.asarray(X, dtype=np.float32)
    n, d = X.shape
    labels = np.asarray(cluster_label, dtype=str)
    with h5py.File(path, "w") as f:
        if sparse:
            import scipy.sparse as sp

            m = sp.csr_matrix(X)
            g = f.create_group("X")
            g.attrs["h5sparse_format"] = "csr"
            g.attrs["h5sparse_shape"] = np.asarray([n, d], dtype=np.int64)
            g.create_dataset("data", data=m.data.astype(np.float32))
            g.create_dataset("indices", data=m.indices.astype(np.int32))
            g.create_dataset("indptr", data=m.indptr.astype(np.int64))
        else:
            f.create_dataset("X", data=X)
        sdt = h5py.string_dtype(encoding="utf-8")
        og = f.create_group("obs")
        og.attrs["_index"] = "index"
        og.create_dataset("index",
                          data=np.array([f"cell_{i}" for i in range(n)],
                                        dtype=object), dtype=sdt)
        cat_table = og.create_group("__categories")
        cats, codes = np.unique(labels, return_inverse=True)
        cat_ds = cat_table.create_dataset("cluster",
                                          data=np.asarray(cats, dtype=object),
                                          dtype=sdt)
        codes_ds = og.create_dataset("cluster", data=codes.astype(np.int8))
        codes_ds.attrs["categories"] = cat_ds.ref
        for k, v in (obs or {}).items():
            og.create_dataset(k, data=np.asarray(v))
        vg = f.create_group("var")
        vg.attrs["_index"] = "index"
        vg.create_dataset("index",
                          data=np.asarray(gene_id, dtype=object), dtype=sdt)
    return path


def load_data(
    datafile: str,
    n_gene: int = 0,
    gene_id: Sequence[str] = (),
    rmv_type: Sequence[str] = (),
    min_num: int = 10,
    eps: float = 1e-1,
    tau: float = 1.0,
    verbose: bool = True,
) -> CellDataset:
    """Load an .h5ad file (reference ``load_data``, dataloader.py:13-70).

    ``min_num`` drops clusters with fewer cells (the reference computes the
    filter but — bug — never applies it to the rows; we apply it, which is
    the evident intent, and keep the label encoding over surviving cells).

    Reading uses anndata when importable, else the h5py-native reader
    below (``read_h5ad_arrays``) — .h5ad is plain HDF5 with a documented
    schema, so real data needs only h5py.
    """
    try:
        import anndata  # optional; h5py fallback below covers real data
    except ImportError:
        X, genes, obs = read_h5ad_arrays(datafile)
    else:
        adata = anndata.read_h5ad(datafile)
        X = adata.X
        genes = np.array(adata.var.index)
        obs = {k: np.asarray(adata.obs[k].values) for k in adata.obs.keys()}
        # the h5py fallback surfaces the obs index as 'cell_id' — keep the
        # two load paths' obs schema identical
        obs.setdefault("cell_id", np.asarray(adata.obs.index))

    if len(gene_id) > 0:
        gene_idx = np.concatenate(
            [np.where(genes == gg)[0] for gg in gene_id]).astype(int)
        genes = genes[gene_idx]
        X = X[:, gene_idx]
    elif n_gene > 0:
        genes = genes[:n_gene]
        X = X[:, :n_gene]

    if hasattr(X, "todense"):
        X = np.asarray(X.todense())
    X = np.asarray(X, dtype=np.float32)

    labels = np.asarray(obs["cluster"]).astype(str)

    keep = np.ones(len(labels), dtype=bool)
    for tt in rmv_type:
        keep &= labels != tt
    uniq, counts = np.unique(labels[keep], return_counts=True)
    small = set(uniq[counts < min_num])
    if small:
        keep &= ~np.isin(labels, list(small))

    X, labels = X[keep], labels[keep]
    obs = {k: v[keep] for k, v in obs.items()}

    cluster_id, onehot, c_p, K = _encode_labels(labels, eps, tau)
    ds = CellDataset(log1p=X, gene_id=genes, cluster_label=labels,
                     cluster_id=cluster_id, c_onehot=onehot, c_p=c_p,
                     n_type=K, obs=obs)
    if verbose:
        print(" --------- Data Summary --------- ")
        print(f"# cell types: {K} | # cells: {ds.n_cells} | # genes: {ds.n_genes}")
    return ds

def synthetic_dataset(n_cells: int = 2000, n_genes: int = 500,
                      n_types: int = 10, seed: int = 0, eps: float = 1e-1,
                      tau: float = 1.0, sparsity: float = 0.7) -> CellDataset:
    """Synthetic log1p-CPM-like data with planted cluster structure:
    sparse non-negative per-type mean programs plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    centers = rng.gamma(2.0, 2.0, (n_types, n_genes)).astype(np.float32)
    centers *= rng.random((n_types, n_genes)) > sparsity
    assign = rng.integers(0, n_types, n_cells)
    X = centers[assign] + rng.normal(0, 0.3, (n_cells, n_genes)).astype(
        np.float32)
    X = np.maximum(X, 0.0).astype(np.float32)

    labels = np.array([f"type_{i:03d}" for i in assign])
    cluster_id, onehot, c_p, K = _encode_labels(labels, eps, tau)
    return CellDataset(
        log1p=X, gene_id=np.array([f"g{j}" for j in range(n_genes)]),
        cluster_label=labels, cluster_id=cluster_id, c_onehot=onehot,
        c_p=c_p, n_type=K)


def hard_synthetic_dataset(
    n_cells: int = 20000,
    n_genes: int = 5032,
    n_types: int = 92,
    seed: int = 0,
    n_roots: int = 12,
    marker_frac: float = 0.03,
    root_frac: float = 0.4,
    lib_mu: Optional[float] = None,  # median log library size; default
                                     # log(2·n_genes): about 2 counts/gene
    lib_sigma: float = 0.6,
    theta_scale: float = 2.0,     # NB inverse dispersion (low = noisy)
    zi_max: float = 0.5,          # dropout ceiling for silent genes
    eps: float = 1e-1,
    tau: float = 1.0,
    chunk: int = 2000,
    device="cpu",
) -> CellDataset:
    """Hard-mode synthetic scRNA-seq: ZINB counts with the failure modes of
    real Smart-seq data (dvae_tpu/data/anndata_io.py:420-530):

      * hierarchy and overlap: ``n_roots`` root expression programs; each
        leaf type perturbs only ``marker_frac`` of its root's genes;
      * abundance imbalance: Dirichlet type proportions;
      * library size: per-cell total counts ~ LogNormal(lib_mu, lib_sigma);
      * overdispersion: per-gene NB theta ~ LogNormal around
        ``theta_scale``;
      * dropout: per-gene zero inflation, strongest for low-expression
        genes.

    Everything up to the count draw is numpy from ``default_rng(seed)`` and
    equals the JAX package's; the counts come from
    ``models/distributions.ZeroInflatedNegativeBinomial.sample`` with a
    ``torch.Generator`` on ``device`` seeded with ``seed``, chunk by chunk,
    and go through ``logcpm``.  Leaf labels are ``r{root:02d}_t{leaf:03d}``.
    """
    import torch

    from dvae_tpu_torch.models.distributions import \
        ZeroInflatedNegativeBinomial
    from dvae_tpu_torch.utils.tools import logcpm

    rng = np.random.default_rng(seed)

    # root programs: sparse heavy-tailed base, per-root fold changes on a
    # root_frac subset of genes
    base = rng.gamma(0.3, 1.0, n_genes)
    roots = np.tile(base, (n_roots, 1))
    for r in range(n_roots):
        sel = rng.random(n_genes) < root_frac
        roots[r, sel] *= rng.lognormal(0.0, 1.5, sel.sum())

    # leaves: each type perturbs marker_frac of its root's genes only
    leaf_root = np.sort(rng.integers(0, n_roots, n_types))
    progs = roots[leaf_root].copy()
    for t in range(n_types):
        sel = rng.random(n_genes) < marker_frac
        progs[t, sel] *= rng.lognormal(0.0, 1.0, sel.sum())
    props = progs / progs.sum(axis=1, keepdims=True)      # (T, D)

    # imbalanced type abundances (floored so the stratified split holds)
    abund = rng.dirichlet(np.full(n_types, 1.5))
    abund = np.maximum(abund, 0.3 / n_types)
    abund /= abund.sum()
    assign = rng.choice(n_types, size=n_cells, p=abund)

    if lib_mu is None:
        lib_mu = float(np.log(2.0 * n_genes))
    lib = rng.lognormal(lib_mu, lib_sigma, n_cells)       # counts/cell

    # per-gene dispersion + expression-dependent dropout
    theta_g = rng.lognormal(np.log(theta_scale), 0.5, n_genes)
    mean_prop = (abund[:, None] * props).sum(axis=0)      # dataset mean
    zi_prob = np.clip(zi_max * np.exp(-2e4 * mean_prop), 0.01, zi_max)
    zi_logits = np.log(zi_prob / (1.0 - zi_prob)).astype(np.float32)

    gen = torch.Generator(device=device).manual_seed(seed)
    theta_t = torch.as_tensor(theta_g, dtype=torch.float32, device=device)
    zi_t = torch.as_tensor(zi_logits, device=device)
    X = np.empty((n_cells, n_genes), np.float32)
    for lo in range(0, n_cells, chunk):
        hi = min(lo + chunk, n_cells)
        mu = (lib[lo:hi, None] * props[assign[lo:hi]]).astype(np.float32)
        d = ZeroInflatedNegativeBinomial(
            mu=torch.as_tensor(mu, device=device), theta=theta_t,
            zi_logits=zi_t)
        X[lo:hi] = logcpm(d.sample(gen).cpu().numpy()).astype(np.float32)

    labels = np.array([f"r{leaf_root[t]:02d}_t{t:03d}" for t in assign])
    cluster_id, onehot, c_p, K = _encode_labels(labels, eps, tau)
    return CellDataset(
        log1p=X, gene_id=np.array([f"g{j}" for j in range(n_genes)]),
        cluster_label=labels, cluster_id=cluster_id, c_onehot=onehot,
        c_p=c_p, n_type=K)
