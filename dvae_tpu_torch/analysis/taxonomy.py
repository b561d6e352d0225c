"""Cell-type reference-taxonomy manipulation of the PyTorch port.

Counterpart of dvae_tpu/analysis/taxonomy.py (reference
``mmidas/utils/taxonomy.py``: HTree :49-409, do_merges :351, simplify_tree
:382, dend_json_to_df :411; ``analysis_cells_tree.py``'s Node,
get_valid_classifications and flatten).  The JAX module keeps the tree in a
pandas DataFrame; here ``HTree`` keeps its six columns (child, parent, x, y,
col, isleaf) as numpy arrays and reads the dend CSV with the ``csv``
module, so the taxonomy path runs where pandas is not installed.  Each
step that pandas does implicitly is done explicitly and in the same way:

  * ``read_csv``'s inference of a column: pandas' missing-value strings,
    integers, floats, ``True``/``TRUE``/``true`` and their negations; a
    column of integer-looking labels reads as their integer text (``01`` →
    ``"1"``), also where a cell is empty (pandas' float column would give
    ``"1.0"`` there);
  * the stable two-key sort on (y, x), NaN last (``np.lexsort``);
  * ``update_layout``'s one-key sort of the leaves' x (the same quicksort
    call on the same values, NaN rows last) and its in-place updates in
    row order;
  * ``value_counts`` in ``simplify_tree``: parents with one child, in the
    order of their first appearance (a stable sort on counts);
  * object-dtype label arrays.

pandas is imported only by the functions that return or take a DataFrame
(``obj2df``, ``parse_dend``, ``dend_json_to_df``); the constructor reads a
DataFrame column by column without importing it.  matplotlib is imported
inside the plotting functions.
"""

from __future__ import annotations

import csv
import json
import re
from copy import deepcopy
from typing import Optional, Sequence

import numpy as np

# pandas.read_csv's default missing-value strings
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"})
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?"
                    r"|[+-]?(inf|Inf|INF|infinity|Infinity)")
_CSV_COLUMNS = ("x", "y", "leaf", "label", "parent", "col")


def _missing(v) -> bool:
    return (v is None or (isinstance(v, float) and v != v)
            or type(v).__name__ in ("NAType", "NaTType"))


def _infer(cells: list) -> list:
    """One CSV column as pandas infers it: None for a missing cell, else
    int, float, bool or the text."""
    vals = [None if c in _NA else c for c in cells]
    present = [v.strip() for v in vals if v is not None]
    if present and all(_INT.fullmatch(v) for v in present):
        return [None if v is None else int(v) for v in vals]
    if present and all(_FLOAT.fullmatch(v) for v in present):
        return [None if v is None else float(v) for v in vals]
    if present and all(v in _TRUE or v in _FALSE for v in present):
        return [None if v is None else v.strip() in _TRUE for v in vals]
    return vals


def _read_dend_csv(path: str) -> dict:
    """The six columns of a dend CSV (x, y, leaf, label, parent, col), each
    a list of values typed as ``pandas.read_csv`` types them."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    missing = [c for c in _CSV_COLUMNS if c not in header]
    if missing:
        raise KeyError(f"{path}: no column {missing}")
    out = {}
    for name in _CSV_COLUMNS:
        j = header.index(name)
        out[name] = _infer([r[j] if j < len(r) else "" for r in body])
    return out


def _values(frame, name: str) -> list:
    """A column of a DataFrame or of a mapping as a list of values."""
    col = frame[name]
    return col.tolist() if hasattr(col, "tolist") else list(col)


def _names(frame) -> list:
    return list(frame.columns) if hasattr(frame, "columns") else list(frame)


class HTree:
    """Hierarchical tree over cell-type labels.

    Construct from a DataFrame, a mapping of column name → sequence, or a
    CSV, with columns ``x, y, leaf, label, parent, col`` (the Allen
    dend.RData export format, reference taxonomy.py:49-81; ``child`` and
    ``isleaf`` are taken for ``label`` and ``leaf``).
    """

    COLUMNS = ("x", "y", "col", "child", "parent", "isleaf")

    def __init__(self, htree_df=None, htree_file: Optional[str] = None):
        if htree_file is not None:
            htree_df = _read_dend_csv(htree_file)
        if htree_df is None:
            raise ValueError("provide htree_df or htree_file")
        names = _names(htree_df)
        child = _values(htree_df, "label" if "label" in names else "child")
        leaf = _values(htree_df, "leaf" if "leaf" in names else "isleaf")
        isleaf = np.array([False if _missing(v) else bool(v) for v in leaf],
                          dtype=bool)
        y = np.array([np.nan if _missing(v) else float(v)
                      for v in _values(htree_df, "y")], dtype=np.float64)
        y[isleaf] = 0.0
        cols = {
            "x": np.array([np.nan if _missing(v) else float(v)
                           for v in _values(htree_df, "x")], np.float64),
            "y": y,
            "col": np.array(["#000000" if _missing(v) else v
                             for v in _values(htree_df, "col")],
                            dtype=object),
            "child": np.array([str(v).strip() for v in child], dtype=object),
            "parent": np.array(["root" if _missing(v) else str(v).strip()
                                for v in _values(htree_df, "parent")],
                               dtype=object),
            "isleaf": isleaf,
        }
        order = np.lexsort((cols["x"], cols["y"]))   # stable, NaN last
        self._cols = {k: v[order] for k, v in cols.items()}

    # -- attribute access mirrors the reference (htree.child etc.) --------
    @property
    def child(self) -> np.ndarray:
        return self._cols["child"]

    @property
    def parent(self) -> np.ndarray:
        return self._cols["parent"]

    @property
    def isleaf(self) -> np.ndarray:
        return self._cols["isleaf"]

    @property
    def x(self) -> np.ndarray:
        return self._cols["x"]

    @property
    def y(self) -> np.ndarray:
        return self._cols["y"]

    @property
    def col(self) -> np.ndarray:
        return self._cols["col"]

    def _rows(self, sel) -> dict:
        """A copy of the columns at ``sel`` (a mask or indices), under the
        column names the constructor takes."""
        return {k: v[sel].copy() for k, v in self._cols.items()}

    def obj2df(self):
        """Reference taxonomy.py:83-86: the columns as a DataFrame (needs
        pandas)."""
        import pandas as pd
        return pd.DataFrame({k: self._cols[k].copy() for k in self.COLUMNS})

    def df2obj(self, htree_df) -> None:
        """Reference taxonomy.py:88-92: take the six columns of a DataFrame
        (or a mapping) as they are."""
        self._cols = {
            "x": np.asarray(_values(htree_df, "x"), np.float64),
            "y": np.asarray(_values(htree_df, "y"), np.float64),
            "col": np.array(_values(htree_df, "col"), dtype=object),
            "child": np.array(_values(htree_df, "child"), dtype=object),
            "parent": np.array(_values(htree_df, "parent"), dtype=object),
            "isleaf": np.asarray(_values(htree_df, "isleaf"), dtype=bool),
        }

    # -- traversal ---------------------------------------------------------

    def get_descendants(self, node: str, leafonly: bool = False) -> list:
        """All descendants of ``node`` (exclusive) — taxonomy.py:207-222.
        Cycle-safe: visited nodes are skipped (a node labelled "root" would
        be its own parent)."""
        descendants = []
        seen = {node}
        frontier = [c for c in self.child[self.parent == node] if c != node]
        descendants.extend(frontier)
        seen.update(frontier)
        while frontier:
            cur = frontier.pop(0)
            nxt = [c for c in self.child[self.parent == cur]
                   if c not in seen]
            seen.update(nxt)
            frontier.extend(nxt)
            descendants.extend(nxt)
        if leafonly:
            leaves = set(self.child[self.isleaf])
            descendants = [d for d in descendants if d in leaves]
        return descendants

    def get_all_descendants(self, leafonly: bool = False) -> dict:
        """taxonomy.py:224-230."""
        return {k: self.get_descendants(k, leafonly)
                for k in np.unique(np.concatenate([self.child, self.parent]))}

    def get_ancestors(self, node: str, rootnode: Optional[str] = None) -> list:
        """taxonomy.py:232-243."""
        ancestors = []
        cur = node
        seen = {node}
        while True:
            nxt = self.parent[self.child == cur]
            if len(nxt) == 0 or nxt[0] in seen:
                break
            cur = nxt[0]
            ancestors.append(cur)
            seen.add(cur)
            if rootnode is not None and cur == rootnode:
                break
        return ancestors

    def get_mergeseq(self) -> list:
        """Ordered [children, parent] merges, shallowest parent first
        (taxonomy.py:245-269)."""
        merge_parents = np.setdiff1d(self.parent, self.child[self.isleaf])
        children = set(self.child.tolist())
        depth = []
        for label in merge_parents:
            if label in children:
                depth.append(float(self.y[self.child == label][0]))
            else:
                depth.append(float(np.max(self.y)) + 0.1)
        order = np.argsort(depth)
        queue = merge_parents[order].tolist()
        merges = []
        while len(queue) > 1:
            parent = queue.pop(0)
            merges.append([self.child[self.parent == parent].tolist(),
                           parent])
        return merges

    def get_subtree(self, node: str) -> "HTree":
        """taxonomy.py:271-279."""
        nodes = self.get_descendants(node) + [node]
        if len(nodes) <= 1:
            raise KeyError(f"node {node!r} not found in tree")
        return HTree(htree_df=self._rows(np.isin(self.child, nodes)))

    def update_layout(self) -> None:
        """Re-space leaves evenly, center parents over descendants
        (taxonomy.py:281-299)."""
        leaves = np.flatnonzero(self.isleaf)
        lx = self.x[leaves]
        nan = np.isnan(lx)
        # pandas' sort_values("x"): a quicksort of the non-NaN values, the
        # NaN rows after them in row order
        order = np.concatenate([leaves[~nan][np.argsort(lx[~nan],
                                                        kind="quicksort")],
                                leaves[nan]])
        x = self.x.astype(float).copy()
        x[order] = np.arange(len(order))
        self._cols["x"] = x
        for node in self.child[~self.isleaf].tolist():
            desc = self.get_descendants(node, leafonly=True)
            sel = np.isin(self.child, desc)
            if sel.any():
                x[self.child == node] = float(x[sel].mean())

    def get_merged_types(self, cells_labels: np.ndarray, num_classes: int = 0,
                         ref_leaf: Sequence[str] = (), node: str = "n4"):
        """Merge fine labels up the tree until ``num_classes`` remain
        (taxonomy.py:301-347).  Returns (merged_labels, mod_subtree,
        subtree)."""
        subtree = self.get_subtree(node)
        if len(ref_leaf) > 0:
            keep_leaf = subtree.isleaf & np.isin(subtree.child,
                                                 list(ref_leaf))
            rows = np.concatenate([np.flatnonzero(keep_leaf),
                                   np.flatnonzero(~subtree.isleaf)])
            subtree = HTree(htree_df=subtree._rows(rows))

        merges = subtree.get_mergeseq()
        go = num_classes if num_classes > 0 else len(merges)

        merged = do_merges(np.array(cells_labels, dtype=object),
                           merges, go - 1)
        uniq_merged = do_merges(
            np.array(subtree.child[subtree.isleaf], dtype=object),
            merges, go - 1)

        kept_leaves = sorted(set(uniq_merged.tolist()))
        kept_nodes = set(kept_leaves)
        for n in kept_leaves:
            kept_nodes.update(subtree.get_ancestors(n))
        cols = subtree._rows(np.isin(subtree.child, list(kept_nodes)))
        now_leaf = np.isin(cols["child"], kept_leaves)
        cols["isleaf"][now_leaf] = True
        cols["y"][now_leaf] = 0.0
        mod_subtree = HTree(htree_df=cols)
        mod_subtree.update_layout()
        return merged, mod_subtree, subtree

    def get_marker(self, exclude: Sequence[str] = ()) -> np.ndarray:
        """Marker-gene names from the leaf labels (reference
        ``HTree.get_marker``, analysis_cells_tree.py:168-198): every
        space-separated token after the first that is not a subclass name.
        ``exclude`` replaces the default subclass list when given."""
        subclass_list = list(exclude) if len(exclude) else [
            "L2/3", "L4", "L5", "L6", "IT", "PT", "NP", "CT", "VISp", "ALM",
            "Sst", "Vip", "Lamp5", "Pvalb", "Sncg", "Serpinf1"]
        marker_genes = []
        for ttype in self.child[self.isleaf]:
            toks = str(ttype).split(" ")[1:]  # tokens after the first
            marker_genes.extend(t for t in toks
                                if t and t not in subclass_list)
        return np.unique(marker_genes)

    # -- plotting (optional matplotlib) -------------------------------------

    def plot(self, figsize=(15, 10), fontsize=10, skeletononly=True,
             fig=None, save_path: Optional[str] = None):
        """Dendrogram skeleton plot (taxonomy.py:94-200, simplified)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if fig is None:
            fig = plt.figure(figsize=figsize)
        ax = fig.gca()
        for i in range(len(self.child)):
            prow = np.flatnonzero(self.child == self.parent[i])
            if len(prow):
                px, py = float(self.x[prow[0]]), float(self.y[prow[0]])
                ax.plot([self.x[i], self.x[i], px],
                        [self.y[i], py, py], "-k", linewidth=0.5)
        if not skeletononly:
            for i in np.flatnonzero(self.isleaf):
                ax.text(self.x[i], self.y[i], self.child[i], rotation=90,
                        fontsize=fontsize, color=self.col[i],
                        ha="center", va="top")
        ax.set_xticks([])
        if save_path:
            fig.savefig(save_path, dpi=300, bbox_inches="tight")
        return fig

    def plotnodes(self, nodelist, fig=None):
        """Overlay red square markers on the named nodes of an existing
        tree figure (reference ``HTree.plotnodes``, taxonomy.py:202-205)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ax = fig.gca() if fig is not None else plt.gca()
        ind = np.isin(self.child, nodelist)
        ax.plot(self.x[ind], self.y[ind], "s", color="r")
        return fig


def do_merges(labels: np.ndarray, list_changes: Sequence = (),
              n_merges: int = 0, verbose: bool = False) -> np.ndarray:
    """Apply the first ``n_merges`` horizontal cuts to a label array
    (reference taxonomy.py:351-380).  Returns the updated array."""
    if not isinstance(labels, np.ndarray):
        raise TypeError("labels must be a numpy array")
    labels = labels.copy()
    for i in range(n_merges):
        if i >= len(list_changes):
            print("Exiting after performing max allowed merges =",
                  len(list_changes))
            break
        children, parent = list_changes[i]
        for c in children:
            n = int(np.sum(labels == c))
            labels[labels == c] = parent
            if verbose:
                print(n, " in ", c, " --> ", parent)
    return labels


def _single_child_parents(parent: np.ndarray) -> list:
    """The parents that occur once, in the order of their first appearance:
    ``value_counts()`` (a stable sort on the counts) filtered to 1."""
    uniq, first, counts = np.unique(parent, return_index=True,
                                    return_counts=True)
    order = np.argsort(first, kind="stable")
    return [u for u, n in zip(uniq[order].tolist(), counts[order]) if n == 1]


def simplify_tree(pruned_subtree: HTree, skip_nodes=None):
    """Remove single-child chain nodes, linking parents directly to
    grandchildren (reference taxonomy.py:382-408)."""
    tree = deepcopy(pruned_subtree)
    if skip_nodes is None:
        skip_nodes = _single_child_parents(tree.parent)
    for node in skip_nodes:
        cols = tree._rows(slice(None))
        above = cols["parent"][cols["child"] == node]
        if above.size == 0:
            continue  # root special case
        cols["parent"][cols["parent"] == node] = above[0]
        keep = cols["child"] != node
        tree = HTree(htree_df={k: v[keep] for k, v in cols.items()})
    return tree, skip_nodes


def parse_dend(htree_file: str):
    """Parse a dend CSV export into merge/descendant structures
    (reference ``parse_dend``, analysis_tree_helpers.py:122-154).

    Returns ``(list_changes, descendants, treeobj, leaves, child, parent)``;
    ``treeobj`` is the sorted tree as a DataFrame in the reference's column
    schema (x, y, leaf, label, parent, col), so this function needs pandas.
    """
    import pandas as pd

    tree = HTree(htree_file=htree_file)
    treeobj = pd.DataFrame({
        "x": tree.x.copy(), "y": tree.y.copy(), "leaf": tree.isleaf.copy(),
        "label": tree.child.copy(), "parent": tree.parent.copy(),
        "col": tree.col.copy()})
    child, parent = tree.child, tree.parent
    leaves = child[tree.isleaf]
    return (tree.get_mergeseq(), tree.get_all_descendants(), treeobj,
            leaves, child, parent)


def plot_htree(htree_file: str, figsize=(15, 10), fontsize=8,
               save_path: Optional[str] = None):
    """Full dendrogram plot with leaf labels from a dend CSV (reference
    ``plot_htree``, analysis_tree_helpers.py:157-196)."""
    tree = HTree(htree_file=htree_file)
    return tree.plot(figsize=figsize, fontsize=fontsize,
                     skeletononly=False, save_path=save_path)


class Node:
    """Tree node over (child, parent) label arrays (reference
    analysis_cells_tree.py:64-91): holds its children/parent names."""

    def __init__(self, name: str, C_list=(), P_list=()):
        C = np.asarray(C_list, dtype=object)
        P = np.asarray(P_list, dtype=object)
        self.name = name
        # exclude self-loops: HTree renders the root's missing parent as
        # "root", which would make a node named "root" its own child
        self.C_name_list = [c for c in (C[P == name] if C.size else [])
                            if c != name]
        self.P_name = list(P[C == name]) if C.size else []

    def __repr__(self):
        return str(self.name)

    __str__ = __repr__

    def __eq__(self, other):
        return isinstance(other, Node) and self.name == other.name

    def __hash__(self):
        return hash(self.name)

    def children(self, C_list=(), P_list=()):
        return [Node(n, C_list, P_list) for n in self.C_name_list]


def get_valid_classifications(current_node_list, C_list, P_list,
                              valid_classes: Optional[list] = None) -> list:
    """All valid 'horizontal cut' classifications of the hierarchy
    (reference ``get_valid_classifications``, analysis_cells_tree.py:93-120):
    starting from [root], repeatedly replace any node by its children;
    every reachable node multiset is one valid classification.  Returns a
    list of sorted name lists (deduplicated, discovery order)."""
    if valid_classes is None:
        valid_classes = []
    nodes = [n if isinstance(n, Node) else Node(n, C_list, P_list)
             for n in current_node_list]
    seen = {tuple(c) for c in valid_classes}

    def visit(node_list):
        node_list = sorted(node_list, key=lambda n: str(n.name))
        names = [str(n.name) for n in node_list]
        key = tuple(names)
        if key in seen:
            return
        seen.add(key)
        valid_classes.append(names)
        for node in node_list:
            children = node.children(C_list=C_list, P_list=P_list)
            if children:
                expanded = [n for n in node_list if n.name != node.name]
                expanded.extend(children)
                visit(expanded)

    visit(nodes)
    return valid_classes


def flatten(nested_dict: dict, separator: str = "_",
            root_keys_to_ignore=None, replace_separators=None) -> dict:
    """Flatten a nested dict/list structure into separator-joined keys
    (reference ``flatten``, analysis_cells_tree.py:17-61)."""
    if not isinstance(nested_dict, dict):
        raise TypeError("flatten requires a dictionary")
    if not isinstance(separator, str):
        raise TypeError("separator must be a string")
    ignore = root_keys_to_ignore or set()
    out: dict = {}

    def mk_key(prev, new):
        new = str(new)
        if replace_separators is not None:
            new = new.replace(separator, replace_separators)
        return f"{prev}{separator}{new}" if prev else new

    def walk(obj, key):
        if not obj:
            out[key] = obj
        elif isinstance(obj, dict):
            for k, v in obj.items():
                if not (key is None and k in ignore):
                    walk(v, mk_key(key, k))
        elif isinstance(obj, (list, set, tuple)):
            for i, item in enumerate(obj):
                walk(item, mk_key(key, i))
        else:
            out[key] = obj

    walk(nested_dict, None)
    return out


def dend_json_to_df(json_file: str):
    """Flatten an Allen dendrogram JSON export into the HTree CSV schema
    (reference taxonomy.py:411-512): columns x/y/leaf/label/parent/col, as
    a DataFrame (needs pandas)."""
    import pandas as pd

    with open(json_file) as f:
        s = f.read().replace("\t", "").replace("\n", "")
        s = s.replace(",}", "}").replace(",]", "]")
        dend = json.loads(s)

    rows = []
    next_x = [0.0]

    def walk(node: dict, parent: Optional[str]):
        attr_key = ("leaf_attribute" if "leaf_attribute" in node
                    else "node_attribute")
        attrs = node.get(attr_key, {})
        if isinstance(attrs, list):
            attrs = attrs[0] if attrs else {}
        label = str(attrs.get("_row", attrs.get("label", f"n{len(rows)}")))
        height = float(attrs.get("height", 0.0))
        color = attrs.get("nodePar.col", attrs.get("col", "#000000"))
        children = node.get("children", [])
        is_leaf = len(children) == 0
        if is_leaf:
            x = next_x[0]
            next_x[0] += 1.0
        else:
            xs = []
            for ch in children:
                xs.append(walk(ch, label))
            x = float(np.mean(xs))
        rows.append({"x": x, "y": height, "leaf": is_leaf, "label": label,
                     "parent": parent, "col": color})
        return x

    walk(dend, None)
    return pd.DataFrame(rows)
