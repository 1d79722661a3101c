"""The port's own host layer against the JAX package's, element for element:
generator, masks, CSR/BSR packers, parameter lines, CSV schema and matrix
readers (the ELL, CSC, LDU, CV and OpenFOAM copies in
``test_torch_formats_rest.py``), and copied functions source for source;
and a static check that no module of the port, nor
``chip_smoke.py``, imports the JAX package or JAX."""

import ast
import dataclasses
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import spgrid.bench.schema as jax_schema
import spgrid.formats.bsr as jax_bsr
import spgrid.formats.csr as jax_csr
import spgrid.formats.sell as jax_sell
import spgrid.gen as jax_gen
import spgrid.gen.masks as jax_masks
import spgrid.io.mtx as jax_mtx
import spgrid.io.smtx as jax_smtx
from spgrid_torch.bench import schema
from spgrid_torch.formats import bsr, csr, sell
from spgrid_torch.gen import artificial, masks, params
from spgrid_torch.io import read_matrix, smtx

# The suite runs in parallel workers on shared cores: one intra-op thread
# a worker keeps these small CPU tensors from oversubscribing them.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

PARAM_LINES = [
    # the README's minimum end-to-end slice, at full size (pure numpy)
    "65535 65535 5 1.6667 normal random 0.05 0 0.05 0.05 14",
    "2000 3000 20 6.6667 gamma diagonal 0.3 100 0.5 0.5 7",
    "512 512 256 32 normal random 1.0 0 0.05 0.05 14",
    "1000 800 10 3 normal simple 0.6 1000 1.4 0.95 3",
]


def assert_same_csr(got, want):
    assert got.shape == want.shape and got.name == want.name
    for field in ("row_ptr", "col_idx", "values"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("line", PARAM_LINES)
def test_generator_and_params_equal_jax(line, monkeypatch, tmp_path):
    monkeypatch.setenv("SPGRID_TORCH_GEN_CACHE", "0")
    monkeypatch.setenv("SPGRID_GEN_CACHE", "0")
    got_p, want_p = (params.GenParams.from_line(line),
                     jax_gen.GenParams.from_line(line))
    assert got_p.kwargs() == want_p.kwargs()
    assert got_p.to_line() == want_p.to_line()
    assert_same_csr(artificial.artificial_matrix_generation(**got_p.kwargs()),
                    jax_gen.artificial_matrix_generation(**want_p.kwargs()))


def test_generator_cache_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGRID_TORCH_GEN_CACHE", str(tmp_path / "port"))
    monkeypatch.setattr(artificial, "_CACHE_MIN_NNZ", 1)
    line = "300 300 5 2 normal random 0.3 0 0.05 0.05 14"
    p = params.GenParams.from_line(line)
    first = artificial.artificial_matrix_generation(**p.kwargs())
    assert len(list((tmp_path / "port").glob("*.npz"))) == 1
    assert artificial._DEFAULT_CACHE != "/tmp/spgrid_gen_cache"
    cached = artificial.artificial_matrix_generation(**p.kwargs())
    np.testing.assert_array_equal(cached.col_idx, first.col_idx)


def test_param_file_equals_jax(tmp_path):
    path = tmp_path / "params.txt"
    path.write_text("# comment\n\n" + "\n".join(PARAM_LINES) + "\n")
    got = [p.kwargs() for p in params.read_param_file(str(path))]
    want = [p.kwargs() for p in jax_gen.read_param_file(str(path))]
    assert got == want


@pytest.mark.parametrize("kind", ["band_and_random", "band_and_decay"])
@pytest.mark.parametrize("length,sparsity,band", [(128, 0.9, None),
                                                  (200, 0.8, 4),
                                                  (333, 0.95, 16)])
def test_masks_equal_jax(kind, length, sparsity, band):
    assert_same_csr(
        masks.create_mask(kind, length, sparsity, band_size=band, seed=3),
        jax_gen.create_mask(kind, length, sparsity, band_size=band, seed=3))


@pytest.mark.parametrize("bm,bk", [(8, 128), (128, 128), (16, 32)])
def test_csr_to_bsr_equals_jax(bm, bk):
    a = jax_csr.random_csr(300, 260, 0.05, seed=4)
    got = bsr.csr_to_bsr(a, bm=bm, bk=bk)
    want = jax_bsr.csr_to_bsr(a, bm=bm, bk=bk, use_native=False)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)


def skewed_with_empty_rows():
    """205 rows (not a multiple of C): rows 30-59 empty, row 100 with 150
    nnz, so slices fall into several width buckets."""
    d = jax_csr.random_csr(205, 180, 0.03, seed=8).to_dense()
    d[30:60] = 0.0
    d[100, 10:160] = 1.5
    return jax_csr.dense_to_csr(d.astype(np.float32), name="skewed_empty")


@pytest.mark.parametrize("make,C,sigma,quantum", [
    (lambda: jax_csr.random_csr(300, 260, 0.05, seed=4), 8, 256, 4),
    (skewed_with_empty_rows, 8, 256, 4),
    (skewed_with_empty_rows, 4, 32, 2),
])
def test_csr_to_sell_equals_jax(make, C, sigma, quantum):
    a = make()
    got = sell.csr_to_sell(a, C=C, sigma=sigma, width_quantum=quantum)
    want = jax_sell.csr_to_sell(a, C=C, sigma=sigma, width_quantum=quantum)
    for name in ("perm", "inv_perm"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert len(got.buckets) == len(want.buckets) > (make is not
                                                    skewed_with_empty_rows)
    for gb, wb in zip(got.buckets, want.buckets):
        for f in dataclasses.fields(wb):
            g, w = getattr(gb, f.name), getattr(wb, f.name)
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
    assert ((got.C, got.sigma, got.shape, got.nnz, got.name)
            == (want.C, want.sigma, want.shape, want.nnz, want.name))
    assert got.mem_footprint == want.mem_footprint
    assert got.padding_ratio == want.padding_ratio
    np.testing.assert_array_equal(sell.sell_to_dense(got),
                                  jax_sell.sell_to_dense(want))
    np.testing.assert_array_equal(sell.sell_to_dense(got), a.to_dense())


def test_csr_helpers_equal_jax():
    assert csr.IDX_DTYPE == jax_csr.IDX_DTYPE
    assert_same_csr(csr.random_csr(90, 70, 0.1, seed=2),
                    jax_csr.random_csr(90, 70, 0.1, seed=2))
    d = jax_csr.random_csr(40, 30, 0.2, seed=3).to_dense()
    assert_same_csr(csr.dense_to_csr(d, name="d"),
                    jax_csr.dense_to_csr(d, name="d"))
    rng = np.random.default_rng(5)
    r, c = rng.integers(0, 20, 100), rng.integers(0, 30, 100)
    v = rng.random(100).astype(np.float32)
    for dup in (True, False):
        assert_same_csr(
            csr.coo_to_csr(csr.COOMatrix(r, c, v, (20, 30)),
                           sum_duplicates=dup),
            jax_csr.coo_to_csr(jax_csr.COOMatrix(r, c, v, (20, 30)),
                               sum_duplicates=dup))


def test_bench_row_schema_equals_jax(tmp_path):
    assert schema.BenchRow.header() == jax_schema.BenchRow.header()
    row = dict(matrix_name="m", kernel="k", input_columns=7, time=1.5e-4,
               errors_passed=1)
    assert (schema.BenchRow(**row).to_csv()
            == jax_schema.BenchRow(**row).to_csv())
    for mod, name in ((schema, "port.csv"), (jax_schema, "jax.csv")):
        w = mod.CSVWriter(str(tmp_path / name))
        w.write(mod.BenchRow(**row))
        assert w.done_keys() == {("m", "k", "7")}
    assert ((tmp_path / "port.csv").read_text()
            == (tmp_path / "jax.csv").read_text())


def test_write_smtx_equals_jax(tmp_path):
    """The same file, byte for byte, and read back as written."""
    a = jax_csr.random_csr(50, 40, 0.1, seed=6)
    smtx.write_smtx(str(tmp_path / "port.smtx"), a)
    jax_smtx.write_smtx(str(tmp_path / "jax.smtx"), a)
    assert ((tmp_path / "port.smtx").read_bytes()
            == (tmp_path / "jax.smtx").read_bytes())
    back = read_matrix(str(tmp_path / "port.smtx"))
    np.testing.assert_array_equal(back.row_ptr, a.row_ptr)
    np.testing.assert_array_equal(back.col_idx, a.col_idx)


@pytest.mark.parametrize("length,sparsity,val_bytes,idx_bytes", [
    (4096, 0.5, 4, 4), (4096, 0.98, 4, 4), (333, 0.9, 2, 8)])
def test_mask_mem_footprint_equals_jax(length, sparsity, val_bytes,
                                       idx_bytes):
    assert (masks.mask_mem_footprint(length, sparsity, val_bytes, idx_bytes)
            == jax_masks.mask_mem_footprint(length, sparsity, val_bytes,
                                            idx_bytes))


def test_matrix_readers_equal_jax(tmp_path):
    a = jax_csr.random_csr(50, 40, 0.1, seed=6)
    jax_mtx.write_mtx(str(tmp_path / "a.mtx"), a)
    jax_smtx.write_smtx(str(tmp_path / "a.smtx"), a)
    (tmp_path / "s.mtx").write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n% c\n"
        "3 3 3\n1 1 2.0\n3 1 -1.5\n2 2 4\n")
    for name, read_jax in (("a.mtx", jax_mtx.read_mtx),
                           ("s.mtx", jax_mtx.read_mtx),
                           ("a.smtx", jax_smtx.read_smtx)):
        path = str(tmp_path / name)
        assert_same_csr(read_matrix(path),
                        read_jax(path, dtype=np.float32, use_native=False))
    with pytest.raises(ValueError):
        read_matrix(str(tmp_path / "a.txt"))


# ml_dtypes and pandas too: the machine with the card has neither
FORBIDDEN = ("spgrid", "jax", "jaxlib", "__graft_entry__", "bench",
             "ml_dtypes", "pandas")


def imported_roots(path: Path):
    """(line, root module) of every import in the file, at any depth."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def port_files():
    return sorted((REPO / "spgrid_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    bad = [(line, root) for line, root in imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_check_sees_nested_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\ndef g():\n    from spgrid.gen import x\n"
                 "    import jax.numpy\n")
    assert [r for _, r in imported_roots(f)] == ["os", "spgrid", "jax"]


def function_sources(module):
    """name -> source of each function defined in ``module``."""
    return {name: inspect.getsource(obj) for name, obj in vars(module).items()
            if inspect.isfunction(obj) and obj.__module__ == module.__name__}


# (port module, JAX module, functions copied verbatim, literal replaced:
# (JAX text, port text))
COPIES = [
    ("spgrid_torch.formats.reorder", "spgrid.formats.reorder",
     ("permute", "rcm_order", "rcm", "first_use_col_order",
      "centroid_col_order", "degree_sort_order", "shuffle_order"), None),
    ("spgrid_torch.ops.costmodel", "spgrid.ops.costmodel",
     ("_dense_time", "_bsr_occupied_blocks", "_bsr_time", "_panel_time",
      "_gell_windowable", "_full_src_rate", "_unfloored_src_rate",
      "_gather_rate", "_gell_slots_tail", "_gell_time", "_ell_time",
      "_coo_time", "_wcoo_bands_slots", "_wcoo_bands_time", "_scoo_time",
      "_merge_time", "_sell_time", "_rbh_time", "_fudged",
      "estimate_spmm_time", "_finite_or_zero", "tolerant_candidates",
      "select_format_cost"),
     ("29e-9", "C.residual_nnz")),
    ("spgrid_torch.formats.ell", "spgrid.formats.ell",
     ("csr_to_ell", "ell_to_csr"), None),
    ("spgrid_torch.formats.csc", "spgrid.formats.csc",
     ("csr_to_csc", "csc_to_csr"), None),
    ("spgrid_torch.formats.ldu", "spgrid.formats.ldu",
     ("csr_to_ldu", "ldu_to_csr"), None),
    ("spgrid_torch.io.openfoam", "spgrid.io.openfoam",
     ("_read_openfoam_labels", "read_openfoam_matrix_dir"), None),
    ("spgrid_torch.formats.csr", "spgrid.formats.csr", ("csr_to_coo",),
     None),
    ("spgrid_torch.features.structural", "spgrid.features.structural",
     ("twin_params",), ("csr: CSRMatrix", "csr")),
    ("spgrid_torch.ops.rbh", "spgrid.ops.rbh", ("_block_counts", "_hi_mask"),
     None),
    # the JAX module binds C at import; the port reads costmodel.C a call
    ("spgrid_torch.ops.sddmm_plan", "spgrid.ops.sddmm_plan",
     ("block_occupancy", "reachable_blocks", "_est_time",
      "choose_sddmm_blocks"), ("C.", "costmodel.C.")),
]


@pytest.mark.parametrize("port,jax,names,literal", COPIES,
                         ids=[c[0] for c in COPIES])
def test_copied_functions_equal_their_originals(port, jax, names, literal):
    """The port's copies of the JAX package's host functions, source for
    source; the cost model's formulas read ``C.residual_nnz`` where the
    JAX package writes the literal 29e-9."""
    got = function_sources(importlib.import_module(port))
    want = function_sources(importlib.import_module(jax))
    for name in names:
        text = want[name]
        if literal is not None:
            text = text.replace(*literal)
        assert got[name] == text, name
