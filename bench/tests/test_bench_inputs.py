"""The benchmark makes its own inputs: the frozen generators are the
port's bit for bit, found by name, and each request's matrix and
right-hand side depend on the seed and the request alone."""
import numpy as np
import pytest
import torch

from harness.matrices import make_matrices
from harness.spec import ROOT, load_module
from harness.traffic import derive_seed
from repro_torch.sparse import generators as port

_JPCG = load_module(ROOT / "bench" / "programs" / "jpcg.py")


def _generator(name):
    return load_module(ROOT / "bench" / "matrices" / f"{name}.py").generate


poisson_2d = _generator("poisson_2d")
diag_dominant_spd = _generator("diag_dominant_spd")


def _same(ours, theirs):
    assert ours.n == theirs.shape[0] == theirs.shape[1]
    for a, b in ((ours.indptr, theirs.indptr), (ours.indices, theirs.indices),
                 (ours.data, theirs.data)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("nx", [1, 2, 7, 40])
def test_poisson_2d_is_the_ports(nx):
    _same(poisson_2d(nx), port.poisson_2d(nx))


@pytest.mark.parametrize("n,nnz,dominance,seed", [
    (50, 16, 1.05, 0), (3000, 70, 1.1, 4), (2000, 9, 2.0, 2 ** 31 + 11),
    (1, 4, 1.1, 3)])
def test_diag_dominant_spd_is_the_ports(n, nnz, dominance, seed):
    _same(diag_dominant_spd(n, nnz, dominance, seed),
          port.diag_dominant_spd(n, nnz_per_row=nnz, dominance=dominance,
                                 seed=seed))


def test_make_matrices_takes_every_parameter_from_the_configuration():
    spec = {"generator": "diag_dominant_spd", "n": 300, "nnz_per_row": 10,
            "dominance": 1.1, "seed": 77}
    got = make_matrices({"matrices": [{"generator": "poisson_2d", "nx": 5},
                                      spec]}, ROOT)
    assert len(got) == 2
    _same(got[0], port.poisson_2d(5))
    _same(got[1], port.diag_dominant_spd(300, nnz_per_row=10, dominance=1.1,
                                         seed=77))


def test_a_new_generator_is_found_by_name(tmp_path):
    (tmp_path / "bench" / "matrices").mkdir(parents=True)
    (tmp_path / "bench" / "matrices" / "identity.py").write_text(
        "import numpy as np\n"
        "from harness.matrices import csr_from_coo\n"
        "def generate(n):\n"
        "    i = np.arange(n)\n"
        "    return csr_from_coo(i, i, np.ones(n), n)\n")
    (a,) = make_matrices({"matrices": [{"generator": "identity", "n": 4}]},
                         tmp_path)
    assert a.n == a.nnz == 4 and np.array_equal(a.diagonal(), np.ones(4))


def test_derive_seed_is_deterministic_and_63_bit():
    for seed in (0, 7, 2 ** 31 + 5, 2 ** 40, 2 ** 64 + 3):
        s = derive_seed(seed, 1, 2)
        assert s == derive_seed(seed, 1, 2) and 0 <= s < 2 ** 63
    assert derive_seed(5, 1, 0) != derive_seed(5, 1, 1)
    assert derive_seed(5, 1, 0) != derive_seed(5, 2, 0)
    assert derive_seed(5, 1, 0) != derive_seed(6, 1, 0)


def _inputs(seed, sizes=(1000,)):
    return _JPCG.Inputs([poisson_2d(int(round(n ** 0.5))) for n in sizes],
                        seed, "cpu")


def test_rhs_depends_on_seed_stream_and_request_alone():
    a, b = _inputs(2 ** 31 + 9), _inputs(2 ** 31 + 9)
    assert torch.equal(a.request(3, "cpu")[1], b.request(3, "cpu")[1])
    a.request(7, "cpu")                      # order of draws does not matter
    assert torch.equal(a.request(4, "cpu")[1], b.request(4, "cpu")[1])
    assert not torch.equal(a.request(3, "cpu")[1], a.request(4, "cpu")[1])
    assert not torch.equal(a.rhs_for(0, 3, "cpu", 1),
                           a.rhs_for(0, 3, "cpu", 2))
    assert not torch.equal(a.request(3, "cpu")[1],
                           _inputs(2 ** 31 + 10).request(3, "cpu")[1])
    m, x = a.request(0, "cpu")
    assert m == 0 and x.dtype == torch.float64 and x.shape == (1024,)
    assert abs(float(x.std()) - 1.0) < 0.1


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3, 2 ** 33 + 1])
def test_every_seed_sends_each_matrix_as_often(seed):
    """Several matrices: each seed sends them in an order of its own, each
    once in every run of as many requests, each b sized for its matrix."""
    inp = _inputs(seed, sizes=(16, 25, 36))
    for start in (0, 3, 6):
        ms = [inp.matrix_of(k) for k in range(start, start + 3)]
        assert sorted(ms) == [0, 1, 2]
    for k in range(6):
        m, b = inp.request(k, "cpu")
        assert b.shape == (inp.matrices[m].n,)
    orders = {tuple(_inputs(s, sizes=(16, 25, 36)).order) for s in range(20)}
    assert len(orders) > 1
