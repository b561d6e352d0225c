"""The PyTorch port's taxonomy path against the JAX package:
``analysis/taxonomy.py`` (HTree without pandas), ``tree_based.
get_merged_types``, ``analysis/hierarchy_viz.py`` and
``examples/taxonomy_study.py``.

The cases of ``tests/test_taxonomy.py``, ``test_hierarchy_viz.py`` and
``test_taxonomy_study.py`` run on the port, and each compares with the JAX
function on the same input.  Trees are compared column by column: labels,
parents, colours and leaf flags exactly, x and y as numbers (the JAX frame
may hold them as integers).  The places where pandas acts implicitly are
covered by their own cases: the stable (y, x) sort, ``update_layout`` on
tied leaf x, ``simplify_tree``'s order over several single-child chains,
and ``read_csv``'s inference (numeric-looking labels, empty cells, R's
``NA``/``TRUE``).  The merge-sweep AMIs (the port's numpy AMI against
sklearn's) are held within 1e-6; the synthetic data bit for bit.
"""

import json

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pandas as pd
import pytest

from dvae_tpu.analysis import hierarchy_viz as jviz
from dvae_tpu.analysis import taxonomy as jtax
from dvae_tpu.analysis import tree_based as jtree
from dvae_tpu.examples import taxonomy_study as jstudy

from dvae_tpu_torch.analysis import hierarchy_viz as tviz
from dvae_tpu_torch.analysis import taxonomy as ttax
from dvae_tpu_torch.analysis import tree_based as ttree
from dvae_tpu_torch.examples import taxonomy_study as tstudy


def _tree_df():
    #        root
    #        /  \
    #      n1    n2
    #     /  \   / \
    #    a    b c   d        (a..d leaves)
    rows = [
        dict(x=0, y=0, leaf=True, label="a", parent="n1", col="#111111"),
        dict(x=1, y=0, leaf=True, label="b", parent="n1", col="#222222"),
        dict(x=2, y=0, leaf=True, label="c", parent="n2", col="#333333"),
        dict(x=3, y=0, leaf=True, label="d", parent="n2", col="#444444"),
        dict(x=0.5, y=1.0, leaf=False, label="n1", parent="root", col=None),
        dict(x=2.5, y=1.5, leaf=False, label="n2", parent="root", col=None),
        dict(x=1.5, y=2.0, leaf=False, label="root", parent=None, col=None),
    ]
    return pd.DataFrame(rows)


def _tied_chain_df():
    """Leaves with tied x (three at 1.0, two at 4.0), internal nodes at tied
    heights, and three single-child chains (m1 → m2 → e, m3 → f, a lone
    leaf under n3)."""
    rows = [
        dict(x=1.0, y=0, leaf=True, label="a", parent="n1", col="#a"),
        dict(x=1.0, y=0, leaf=True, label="b", parent="n1", col="#b"),
        dict(x=1.0, y=0, leaf=True, label="c", parent="n2", col=None),
        dict(x=4.0, y=0, leaf=True, label="d", parent="n2", col="#d"),
        dict(x=4.0, y=0, leaf=True, label="e", parent="m2", col="#e"),
        dict(x=0.0, y=0, leaf=True, label="f", parent="m3", col="#f"),
        dict(x=2.0, y=0, leaf=True, label="g", parent="n3", col="#g"),
        dict(x=3.0, y=0.5, leaf=False, label="m2", parent="m1", col=None),
        dict(x=3.0, y=1.0, leaf=False, label="m1", parent="top", col=None),
        dict(x=0.0, y=1.0, leaf=False, label="m3", parent="n2", col=None),
        dict(x=1.0, y=1.0, leaf=False, label="n1", parent="top", col=None),
        dict(x=2.0, y=1.5, leaf=False, label="n2", parent="top", col=None),
        dict(x=2.0, y=1.5, leaf=False, label="n3", parent="n2", col=None),
        dict(x=2.0, y=3.0, leaf=False, label="top", parent=None, col=None),
    ]
    return pd.DataFrame(rows)


def _columns(tree) -> dict:
    return {k: np.asarray(getattr(tree, k), dtype=object).tolist()
            for k in ("child", "parent", "col", "isleaf")} | {
        k: np.asarray(getattr(tree, k), dtype=np.float64)
        for k in ("x", "y")}


def assert_same_tree(port, jax_tree):
    got, want = _columns(port), _columns(jax_tree)
    for k in ("child", "parent", "col", "isleaf"):
        assert got[k] == want[k], k
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port.child.dtype == object and port.isleaf.dtype == bool


@pytest.fixture
def tree():
    return ttax.HTree(htree_df=_tree_df())


@pytest.fixture
def jtree_():
    return jtax.HTree(htree_df=_tree_df())


# ---------------------------------------------------------------------------
# The cases of tests/test_taxonomy.py on the port, each against JAX
# ---------------------------------------------------------------------------

def test_descendants_and_ancestors(tree, jtree_):
    assert set(tree.get_descendants("n1")) == {"a", "b"}
    assert set(tree.get_descendants("root")) == {"n1", "n2", "a", "b",
                                                 "c", "d"}
    assert set(tree.get_descendants("root", leafonly=True)) == {"a", "b",
                                                                "c", "d"}
    assert tree.get_ancestors("a") == ["n1", "root"]
    assert tree.get_ancestors("a", rootnode="n1") == ["n1"]
    for node in ("root", "n1", "n2", "a"):
        for leafonly in (False, True):
            assert (tree.get_descendants(node, leafonly)
                    == jtree_.get_descendants(node, leafonly))
        assert tree.get_ancestors(node) == jtree_.get_ancestors(node)
    assert_same_tree(tree, jtree_)


def test_mergeseq_order_shallowest_first(tree, jtree_):
    merges = tree.get_mergeseq()
    assert merges[0] == [["a", "b"], "n1"]
    assert merges[1] == [["c", "d"], "n2"]
    assert merges == jtree_.get_mergeseq()


def test_do_merges_successive_cuts(tree, jtree_):
    labels = np.array(["a", "b", "c", "d", "a"], dtype=object)
    merges = tree.get_mergeseq()
    m1 = ttax.do_merges(labels, merges, 1)
    assert m1.tolist() == ["n1", "n1", "c", "d", "n1"]
    m2 = ttax.do_merges(labels, merges, 2)
    assert m2.tolist() == ["n1", "n1", "n2", "n2", "n1"]
    assert labels.tolist() == ["a", "b", "c", "d", "a"]
    for n in range(4):
        assert (ttax.do_merges(labels, merges, n).tolist()
                == jtax.do_merges(labels, jtree_.get_mergeseq(), n).tolist())


def test_subtree(tree, jtree_):
    sub = tree.get_subtree("n1")
    assert set(sub.child) == {"a", "b", "n1"}
    assert_same_tree(sub, jtree_.get_subtree("n1"))
    with pytest.raises(KeyError):
        tree.get_subtree("nowhere")


def test_get_merged_types(tree, jtree_):
    cells = np.array(["a", "b", "c", "d"] * 5, dtype=object)
    merged, mod_subtree, subtree = tree.get_merged_types(
        cells, num_classes=2, node="root")
    assert set(merged.tolist()) == {"n1", "c", "d"}
    jm, jmod, jsub = jtree_.get_merged_types(cells, num_classes=2,
                                             node="root")
    assert merged.tolist() == jm.tolist() and merged.dtype == object
    assert_same_tree(mod_subtree, jmod)
    assert_same_tree(subtree, jsub)


def test_simplify_tree_removes_chain():
    rows = [
        dict(x=0, y=0, leaf=True, label="a", parent="mid", col=None),
        dict(x=0, y=1, leaf=False, label="mid", parent="top", col=None),
        dict(x=1, y=0, leaf=True, label="b", parent="top", col=None),
        dict(x=0.5, y=2, leaf=False, label="top", parent=None, col=None),
    ]
    tree = ttax.HTree(htree_df=pd.DataFrame(rows))
    simple, skipped = ttax.simplify_tree(tree)
    assert "mid" in skipped
    assert simple.parent[list(simple.child).index("a")] == "top"
    assert "mid" not in simple.child.tolist()
    jsimple, jskipped = jtax.simplify_tree(
        jtax.HTree(htree_df=pd.DataFrame(rows)))
    assert skipped == jskipped
    assert_same_tree(simple, jsimple)


def test_parse_dend(tmp_path):
    p = tmp_path / "dend.csv"
    _tree_df().to_csv(p, index=False)
    got = ttax.parse_dend(str(p))
    want = jtax.parse_dend(str(p))
    list_changes, descendants, treeobj, leaves, child, parent = got
    assert list_changes[0] == [["a", "b"], "n1"]
    assert set(descendants["n1"]) == {"a", "b"}
    assert set(descendants["root"]) == {"n1", "n2", "a", "b", "c", "d"}
    assert set(leaves) == {"a", "b", "c", "d"}
    assert list(treeobj.columns) == ["x", "y", "leaf", "label", "parent",
                                     "col"]
    assert len(child) == len(parent) == 7
    assert list_changes == want[0]
    assert descendants == want[1]
    for c in treeobj.columns:
        assert treeobj[c].tolist() == want[2][c].tolist(), c
    for g, w in zip(got[3:], want[3:]):
        assert np.asarray(g, dtype=object).tolist() == \
            np.asarray(w, dtype=object).tolist()


def test_plot_htree(tmp_path):
    p = tmp_path / "dend.csv"
    _tree_df().to_csv(p, index=False)
    fig = ttax.plot_htree(str(p), save_path=str(tmp_path / "tree.png"))
    assert fig is not None
    assert (tmp_path / "tree.png").exists()
    import matplotlib.pyplot as plt
    jfig = jtax.plot_htree(str(p))
    # the same skeleton segments and leaf labels as the JAX plot's
    seg = [ln.get_xydata().tolist() for ln in fig.gca().lines]
    assert seg == [ln.get_xydata().tolist() for ln in jfig.gca().lines]
    assert ([t.get_text() for t in fig.gca().texts]
            == [t.get_text() for t in jfig.gca().texts])
    plt.close("all")


def test_get_valid_classifications(tree, jtree_):
    got = ttax.get_valid_classifications(["root"], tree.child, tree.parent,
                                         [])
    as_sets = {frozenset(c) for c in got}
    assert as_sets == {
        frozenset({"root"}),
        frozenset({"n1", "n2"}),
        frozenset({"a", "b", "n2"}),
        frozenset({"n1", "c", "d"}),
        frozenset({"a", "b", "c", "d"}),
    }
    assert got[0] == ["root"]
    assert all(c == sorted(c) for c in got)
    assert got == jtax.get_valid_classifications(
        ["root"], jtree_.child, jtree_.parent, [])


def test_flatten_nested():
    nested = {"a": {"b": 1, "c": [10, {"d": 2}]}, "e": 3}
    flat = ttax.flatten(nested)
    assert flat == {"a_b": 1, "a_c_0": 10, "a_c_1_d": 2, "e": 3}
    flat2 = ttax.flatten(nested, separator=".", root_keys_to_ignore={"e"})
    assert flat2 == {"a.b": 1, "a.c.0": 10, "a.c.1.d": 2}
    for kw in ({}, {"separator": "."}, {"replace_separators": "-"},
               {"root_keys_to_ignore": {"a"}}):
        assert ttax.flatten(nested, **kw) == jtax.flatten(nested, **kw)


def test_get_marker():
    rows = [
        dict(x=0, y=0, leaf=True, label="L2/3 IT VISp Agmat",
             parent="n1", col="#111111"),
        dict(x=1, y=0, leaf=True, label="Sst Calb2 Pdlim5",
             parent="n1", col="#222222"),
        dict(x=0.5, y=1, leaf=False, label="n1", parent=None, col=None),
    ]
    t = ttax.HTree(htree_df=pd.DataFrame(rows))
    assert t.get_marker().tolist() == ["Agmat", "Calb2", "Pdlim5"]
    assert "VISp" in t.get_marker(exclude=["IT"]).tolist()
    j = jtax.HTree(htree_df=pd.DataFrame(rows))
    for ex in ((), ["IT"]):
        assert t.get_marker(ex).tolist() == j.get_marker(ex).tolist()


def _dend_json(tmp_path, numeric: bool):
    def leaf(name, **kw):
        return {"leaf_attribute": {"_row": name, "height": 0.0, **kw}}
    dend = {
        "node_attribute": {"_row": 10 if numeric else "root", "height": 2.0},
        "children": [
            {"node_attribute": {"_row": 11 if numeric else "n1",
                                "height": 1.0},
             "children": [leaf(1 if numeric else "a",
                               **{"nodePar.col": "#ff0000"}),
                          leaf(2 if numeric else "b")]},
            leaf(3 if numeric else "c"),
        ],
    }
    p = tmp_path / "dend.json"
    p.write_text(json.dumps(dend))
    return p


@pytest.mark.parametrize("numeric", [False, True])
def test_dend_json_roundtrip(tmp_path, numeric):
    p = _dend_json(tmp_path, numeric)
    df = ttax.dend_json_to_df(str(p))
    jdf = jtax.dend_json_to_df(str(p))
    pd.testing.assert_frame_equal(df, jdf)
    tree = ttax.HTree(htree_df=df)
    root, n1, a = ("10", "11", "1") if numeric else ("root", "n1", "a")
    leaves = {"1", "2", "3"} if numeric else {"a", "b", "c"}
    assert set(tree.get_descendants(root, leafonly=True)) == leaves
    assert len(tree.get_descendants(n1)) == 2
    assert tree.col[list(tree.child).index(a)] == "#ff0000"
    assert_same_tree(tree, jtax.HTree(htree_df=jdf))
    # and through a CSV written by pandas, read without it.  With numeric
    # labels the root's empty parent cell makes pandas read the parents as
    # floats ("11.0", which names no node); the port keeps "11", so its
    # tree is the frame's
    csv = tmp_path / "dend.csv"
    jdf.to_csv(csv, index=False)
    want = (jtax.HTree(htree_df=jdf) if numeric
            else jtax.HTree(htree_file=str(csv)))
    assert_same_tree(ttax.HTree(htree_file=str(csv)), want)


def test_plotnodes_marks_named_nodes(tree):
    tree.update_layout()
    fig = tree.plot()
    fig = tree.plotnodes(["a", "n1"], fig=fig)
    pts = fig.gca().lines[-1]
    assert len(pts.get_xdata()) == 2
    import matplotlib.pyplot as plt
    plt.close("all")


# ---------------------------------------------------------------------------
# HTree's inputs and the places where pandas acts implicitly
# ---------------------------------------------------------------------------

def test_mapping_dataframe_and_csv_give_one_tree(tmp_path):
    df = _tied_chain_df()
    p = tmp_path / "dend.csv"
    df.to_csv(p, index=False)
    from_df = ttax.HTree(htree_df=df)
    from_map = ttax.HTree(htree_df={k: df[k].tolist() for k in df.columns})
    from_csv = ttax.HTree(htree_file=str(p))
    want = jtax.HTree(htree_df=df)
    for t in (from_df, from_map, from_csv):
        assert_same_tree(t, want)
    assert_same_tree(from_csv, jtax.HTree(htree_file=str(p)))
    with pytest.raises(ValueError):
        ttax.HTree()


@pytest.mark.parametrize("make", [_tree_df, _tied_chain_df])
def test_update_layout_equals_jax(make):
    """The leaves' quicksort on x (ties in the rows' order as pandas'
    argsort leaves them) and the parents centred in row order."""
    t, j = ttax.HTree(htree_df=make()), jtax.HTree(htree_df=make())
    t.update_layout()
    j.update_layout()
    assert_same_tree(t, j)


@pytest.mark.parametrize("make", [_tree_df, _tied_chain_df])
def test_simplify_tree_order_equals_jax(make):
    """``value_counts``' order among the parents with one child sets the
    skip list and the order of removal."""
    t, skipped = ttax.simplify_tree(ttax.HTree(htree_df=make()))
    j, jskipped = jtax.simplify_tree(jtax.HTree(htree_df=make()))
    assert skipped == jskipped
    assert_same_tree(t, j)
    # an explicit skip list, in another order
    order = list(reversed(jskipped))
    t2, _ = ttax.simplify_tree(ttax.HTree(htree_df=make()), order)
    j2, _ = jtax.simplify_tree(jtax.HTree(htree_df=make()), order)
    assert_same_tree(t2, j2)


def test_chain_tree_merges_equal_jax():
    t, j = (ttax.HTree(htree_df=_tied_chain_df()),
            jtax.HTree(htree_df=_tied_chain_df()))
    assert t.get_mergeseq() == j.get_mergeseq()
    td, jd = t.get_all_descendants(), j.get_all_descendants()
    assert list(td) == list(jd) and all(td[k] == jd[k] for k in jd)
    cells = np.array(list("abcdefg") * 3, dtype=object)
    for k in range(0, 9):
        got = t.get_merged_types(cells, num_classes=k, node="top")
        want = j.get_merged_types(cells, num_classes=k, node="top")
        assert got[0].tolist() == want[0].tolist(), k
        assert_same_tree(got[1], want[1])
        assert_same_tree(got[2], want[2])


_CSV_CASES = {
    # Allen/R style: NA for the root's parent and the internal leaf flags
    "r_export": ("x,y,leaf,label,parent,col\n"
                 "0,NA,TRUE,a,n1,#111111\n1,NA,TRUE,b,n1,#222222\n"
                 "2,NA,TRUE,c,n2,#333333\n0.5,1,NA,n1,root,NA\n"
                 "2,1.5,NA,n2,root,NA\n1.25,2,NA,root,NA,NA\n"),
    # pandas' own export of booleans, empty cells, extra column
    "pandas_export": ("idx,x,y,leaf,label,parent,col\n"
                      "0,0,0.0,True,a,n1,#111111\n1,1,0.0,True,b,n1,\n"
                      "2,0.5,1.0,False,n1,,\n"),
    # numeric-looking leaf labels under named internal nodes; one label
    # with surrounding spaces
    "numeric_labels": ("x,y,leaf,label,parent,col\n"
                       "0,0,TRUE,1,n1,#a\n1,0,TRUE,2,n1,#b\n"
                       "2,0,TRUE, 3 ,n2,#c\n3,0,True,4,n2,\n"
                       "0.5,1,,n1,n0,\n2.5,1,,n2,n0,\n1.5,2,,n0,,\n"),
    # integer labels everywhere but the root's empty parent cell: a column
    # of integers read as their text (pandas' float column is not)
    "integer_labels": ("x,y,leaf,label,parent,col\n"
                       "0,0,TRUE,01,7,#a\n1,0,TRUE,2,7,#b\n"
                       "0.5,1,FALSE,7,9,#c\n0.5,2,FALSE,9,abc,#d\n"),
}


@pytest.mark.parametrize("case", sorted(_CSV_CASES))
def test_dend_csv_read_equals_pandas(tmp_path, case):
    p = tmp_path / "dend.csv"
    p.write_text(_CSV_CASES[case])
    t, j = ttax.HTree(htree_file=str(p)), jtax.HTree(htree_file=str(p))
    assert_same_tree(t, j)
    assert t.get_mergeseq() == j.get_mergeseq()
    root = t.child[np.argmax(t.y)]
    cells = t.child[t.isleaf]
    for k in range(0, len(cells) + 1):
        got = ttree.get_merged_types(str(p), cells, num_classes=k,
                                     node=root)
        want = jtree.get_merged_types(str(p), cells, num_classes=k,
                                      node=root)
        assert got[0].tolist() == want[0].tolist()
        assert_same_tree(got[1], want[1])


def test_integer_labels_keep_their_text_where_a_cell_is_empty(tmp_path):
    """A label column of integers with an empty cell: pandas reads floats
    (``"1.0"``); the port keeps the integers' text."""
    p = tmp_path / "dend.csv"
    p.write_text("x,y,leaf,label,parent,col\n0,0,TRUE,1,3,#a\n"
                 "1,0,TRUE,2,3,#b\n0.5,1,,3,,\n")
    t = ttax.HTree(htree_file=str(p))
    assert t.child.tolist() == ["1", "2", "3"]
    assert t.parent.tolist() == ["3", "3", "root"]
    assert t.get_descendants("3") == ["1", "2"]


def test_obj2df_and_df2obj_equal_jax(tree, jtree_):
    df = tree.obj2df()
    jdf = jtree_.obj2df()
    assert list(df.columns) == list(jdf.columns)
    for c in df.columns:
        assert df[c].tolist() == jdf[c].tolist(), c
    t2 = ttax.HTree(htree_df=_tree_df())
    t2.df2obj(jdf.iloc[::-1])
    jtree_.df2obj(jdf.iloc[::-1])
    assert_same_tree(t2, jtree_)


@pytest.mark.parametrize("depth", [3, 4, 5, 6, 7])
def test_synthetic_tree_equals_jax(depth):
    """Columns, merge sequence, descendants, and ``get_merged_types`` of
    the port's tree equal JAX's: at every number of classes for depth 3-5;
    at depth 6 and 7 (the JAX frame takes 0.3-0.7 s a call) at 0, 1, 2, 3,
    each power of two plus one, and the last three; with ``ref_leaf`` at a
    subtree."""
    t, names = tstudy.synthetic_taxonomy(depth)
    j, jnames = jstudy.synthetic_taxonomy(depth)
    assert names == jnames
    assert_same_tree(t, j)
    assert t.get_mergeseq() == j.get_mergeseq()
    td, jd = t.get_all_descendants(), j.get_all_descendants()
    assert list(td) == list(jd) and all(td[k] == jd[k] for k in jd)
    td, jd = t.get_all_descendants(True), j.get_all_descendants(True)
    assert all(td[k] == jd[k] for k in jd)
    n = 2 ** depth
    cells = np.random.default_rng(depth).choice(np.array(names), 300)
    levels = (range(n + 2) if depth <= 5 else
              sorted({0, 1, 2, 3, n - 1, n, n + 1}
                     | {2 ** i + 1 for i in range(depth)}))
    for k in levels:
        got = t.get_merged_types(cells, num_classes=k, node="n1")
        want = j.get_merged_types(cells, num_classes=k, node="n1")
        assert got[0].tolist() == want[0].tolist(), k
        assert got[0].dtype == object
        assert_same_tree(got[1], want[1])
        assert_same_tree(got[2], want[2])
    ref = names[::3]
    got = t.get_merged_types(cells, num_classes=3, ref_leaf=ref, node="n2")
    want = j.get_merged_types(cells, num_classes=3, ref_leaf=ref, node="n2")
    assert got[0].tolist() == want[0].tolist()
    assert_same_tree(got[1], want[1])
    assert_same_tree(got[2], want[2])


def test_get_merged_types_from_csv_at_every_level(tmp_path):
    """``tree_based.get_merged_types`` of a dend CSV (read without pandas)
    equals JAX's and the in-memory tree's at every level."""
    t, names = tstudy.synthetic_taxonomy(4)
    p = tmp_path / "dend.csv"
    pd.DataFrame({"x": t.x, "y": t.y, "leaf": t.isleaf, "label": t.child,
                  "parent": t.parent, "col": t.col}).to_csv(p, index=False)
    cells = np.random.default_rng(0).choice(np.array(names), 200)
    for k in range(0, 18):
        got = ttree.get_merged_types(str(p), cells, num_classes=k,
                                     node="n1")
        want = jtree.get_merged_types(str(p), cells, num_classes=k,
                                      node="n1")
        mem = t.get_merged_types(cells, num_classes=k, node="n1")
        assert got[0].tolist() == want[0].tolist() == mem[0].tolist()
        assert_same_tree(got[1], want[1])
        assert_same_tree(got[1], mem[1])


# ---------------------------------------------------------------------------
# hierarchy_viz: the cases of tests/test_hierarchy_viz.py
# ---------------------------------------------------------------------------

def test_cell_nodes_dict_ancestor_chains(tree, jtree_):
    d = tviz.cell_nodes_dict(tree, num_cell=10)
    assert d["a"] == ["n1", "root"]
    assert d["d"] == ["n2", "root"]
    assert d["n1"] == ["root"]
    assert len(tviz.cell_nodes_dict(tree, num_cell=1)) == 2
    for n in (1, 3, 10):
        assert (tviz.cell_nodes_dict(tree, n)
                == jviz.cell_nodes_dict(jtree_, n))


def test_hierarchy_plot_returns_fig(tree, jtree_, tmp_path):
    import matplotlib.pyplot as plt

    p_cat = np.array([0.5, 0.2, 0.2, 0.1])
    ax, fig = tviz.hierarchy_plot(tree, p_cat, ["a", "b", "c", "d"],
                                  save_path=str(tmp_path / "h.png"))
    assert (tmp_path / "h.png").exists()
    jax_ax, _ = jviz.hierarchy_plot(jtree_, p_cat, ["a", "b", "c", "d"])
    assert ([p.get_height() for p in ax.patches]
            == [p.get_height() for p in jax_ax.patches])
    plt.close("all")


def test_heatmap_plot_taxonomy_column_order(tree, jtree_, tmp_path):
    import matplotlib.pyplot as plt

    K = 3
    cluster_per_cat = np.arange(K * 4, dtype=float).reshape(K, 4)
    unique_types = ["d", "c", "b", "a"]   # reversed
    fig, mat = tviz.heatmap_plot(tree, cluster_per_cat, unique_types,
                                 leaf_size=4,
                                 save_path=str(tmp_path / "hm.png"))
    np.testing.assert_array_equal(mat, cluster_per_cat[:, [3, 2, 1, 0]])
    assert (tmp_path / "hm.png").exists()
    _, jmat = jviz.heatmap_plot(jtree_, cluster_per_cat, unique_types,
                                leaf_size=4)
    np.testing.assert_array_equal(mat, jmat)
    plt.close("all")


def test_dent_plot_smoke(tree):
    import matplotlib.pyplot as plt

    fig = tviz.dent_plot(tree, np.eye(4))
    fig2 = tviz.dent_plot(tree, np.eye(4)[::-1], types=["d", "c", "b", "a"])
    assert fig is not None and fig2 is not None
    plt.close("all")


# ---------------------------------------------------------------------------
# The study: the cases of tests/test_taxonomy_study.py
# ---------------------------------------------------------------------------

def test_synthetic_taxonomy_schema():
    tree, leaves = tstudy.synthetic_taxonomy(depth=3)
    assert len(leaves) == 8
    assert sorted(tree.child[tree.isleaf]) == leaves
    assert len(tree.get_mergeseq()) == 7
    assert "n1" in tree.parent
    for leaf in leaves:
        assert "n1" in tree.get_ancestors(leaf)


def test_hierarchy_respected_by_expression():
    _, X, labels = tstudy.hierarchical_synthetic(depth=3, n_cells=800,
                                                 n_genes=64, seed=0)
    cent = {l: X[labels == l].mean(0) for l in np.unique(labels)}
    d = lambda a, b: np.linalg.norm(cent[a] - cent[b])
    assert d("t00", "t01") < d("t00", "t02") < d("t00", "t07")


@pytest.mark.parametrize("depth,n_cells,n_genes,seed",
                         [(3, 600, 32, 1), (4, 500, 40, 7), (6, 300, 20, 3)])
def test_hierarchical_synthetic_bit_for_bit(depth, n_cells, n_genes, seed):
    t, X, labels = tstudy.hierarchical_synthetic(depth, n_cells, n_genes,
                                                 seed)
    j, jX, jlabels = jstudy.hierarchical_synthetic(depth, n_cells, n_genes,
                                                   seed)
    assert X.dtype == jX.dtype == np.float32
    assert X.tobytes() == jX.tobytes()
    assert labels.dtype == jlabels.dtype
    assert labels.tolist() == jlabels.tolist()
    assert_same_tree(t, j)


def test_merge_sweep_peaks_at_the_true_level():
    tree, X, labels = tstudy.hierarchical_synthetic(depth=3, n_cells=600,
                                                    n_genes=32, seed=1)
    merged4, _, _ = tree.get_merged_types(labels, num_classes=5, node="n1")
    rows = tstudy.merge_sweep(tree, labels, np.stack([merged4, merged4]))
    by_k = {r["n_classes"]: np.mean(r["ami"]) for r in rows}
    assert by_k[4] == pytest.approx(1.0)
    assert all(v < 1.0 for k, v in by_k.items() if k != 4)
    ks = [r["n_classes"] for r in rows]
    assert ks == sorted(ks, reverse=True) and len(set(ks)) == len(ks)


@pytest.mark.parametrize("depth", [3, 4])
def test_merge_sweep_equals_jax(depth):
    """The rows of the sweep (levels, merges applied) exactly and every AMI
    within 1e-6 of JAX's sklearn ones, on noisy predicted labels of 5
    arms."""
    tree, X, labels = tstudy.hierarchical_synthetic(depth, 400, 16, seed=2)
    jtree_, _, _ = jstudy.hierarchical_synthetic(depth, 400, 16, seed=2)
    rng = np.random.default_rng(depth)
    n = 2 ** depth
    truth_idx = np.array([int(s[1:]) for s in labels])
    pred = np.stack([np.where(rng.random(400) < p, rng.integers(0, n, 400),
                              truth_idx // 2)
                     for p in (0.0, 0.1, 0.3, 0.6, 1.0)])
    got = tstudy.merge_sweep(tree, labels, pred)
    want = jstudy.merge_sweep(jtree_, labels, pred)
    assert ([(r["n_classes"], r["merges_applied"]) for r in got]
            == [(r["n_classes"], r["merges_applied"]) for r in want])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["ami"], w["ami"], atol=1e-6, rtol=0)


def test_taxonomy_study_end_to_end(tmp_path):
    """Tiny full run on the CPU: train (20 epochs), sweep, plot files on
    disk, sane metrics."""
    out = tstudy.run(depth=3, n_cells=320, n_genes=48, n_categories=12,
                     batch_size=80, n_epoch=20, epochs_per_jit=10,
                     folder=str(tmp_path), verbose=False, device="cpu")
    assert out["n_leaves"] == 8
    assert len(out["leaf_ami"]) == 2
    assert all(np.isfinite(out["leaf_ami"]))
    assert out["levels"] and out["best_level"] is not None
    for r in out["levels"]:
        assert 2 <= r["n_classes"] <= 8
        assert all(-0.5 <= a <= 1.0 for a in r["ami"])
    for name in out["plots"]:
        assert (tmp_path / name).exists()
    assert (tmp_path / "cpl_mixVAE_model_best_train.ckpt").exists()


def test_taxonomy_study_cli(tmp_path):
    assert tstudy.main(["--depth", "2", "--cells", "120", "--genes", "16",
                        "--batch_size", "40", "--epochs", "2",
                        "--folder", str(tmp_path), "--device", "cpu"]) == 0
