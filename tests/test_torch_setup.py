"""Port vs JAX package: host-side setup on the CPU.

The problem generator, the decomposition's index arrays and the packed
local matrices must be byte-equal (the port copies the host code, so any
difference is a porting fault); the option parser must give equal values.
"""

import numpy as np
import pytest
import torch

from hpddm_tpu.core.formats import pack_local_matrices as jax_pack
from hpddm_tpu.models import diffusion2d as jax_d2
from hpddm_tpu.options import Options as JaxOptions
from hpddm_tpu.parallel.decomposition import Decomposition as JaxDec

from hpddm_tpu_torch.core.formats import pack_local_matrices
from hpddm_tpu_torch.models import diffusion2d
from hpddm_tpu_torch.options import Options
from hpddm_tpu_torch.parallel.decomposition import Decomposition

CONFIGS = [(4, 40, 40), (2, 100, 60), (6, 30, 30)]


def _gen_pair(S, Nx, Ny, dtype=np.float64):
    return (jax_d2.generate(S, Nx, Ny, overlap=1, with_neumann=True,
                            dtype=dtype),
            diffusion2d.generate(S, Nx, Ny, overlap=1, with_neumann=True,
                                 dtype=dtype))


def _assert_csr_equal(a, b):
    assert (a.n, a.m, a.sym) == (b.n, b.m, b.sym)
    for arr_a, arr_b in ((a.ia, b.ia), (a.ja, b.ja), (a.a, b.a)):
        assert arr_a.dtype == arr_b.dtype
        np.testing.assert_array_equal(arr_a, arr_b)


@pytest.mark.parametrize("S,Nx,Ny", CONFIGS)
def test_generate_byte_equal(S, Nx, Ny):
    ref, port = _gen_pair(S, Nx, Ny)
    assert port.n_loc == ref.n_loc and port.grid == ref.grid
    assert port.boxes == ref.boxes and port.neighbors == ref.neighbors
    for s in range(S):
        _assert_csr_equal(port.mats[s], ref.mats[s])
        _assert_csr_equal(port.neumann[s], ref.neumann[s])
        assert port.d[s].tobytes() == ref.d[s].tobytes()
        assert port.f[s].tobytes() == ref.f[s].tobytes()
        assert len(port.mappings[s]) == len(ref.mappings[s])
        for mp, mr in zip(port.mappings[s], ref.mappings[s]):
            np.testing.assert_array_equal(mp, mr)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("S,Nx,Ny", CONFIGS)
def test_decomposition_arrays_equal(S, Nx, Ny, dtype):
    ref_gen, gen = _gen_pair(S, Nx, Ny, dtype)
    ref = JaxDec.from_subdomains(ref_gen.neighbors, ref_gen.mappings,
                                 ref_gen.n_loc, d=ref_gen.d, dtype=dtype)
    dec = Decomposition.from_subdomains(gen.neighbors, gen.mappings,
                                        gen.n_loc, d=gen.d, dtype=dtype,
                                        device="cpu")
    for key in ("S", "n_max", "m_max", "n_if", "n_global", "k_max",
                "sub_shifts"):
        assert getattr(dec, key) == getattr(ref, key), key
    for key in ("n_loc", "d", "if_idx", "if_gid", "if_mask", "ov_mask",
                "mult", "partners", "inv_map", "is_if", "row_mask"):
        got = getattr(dec, key).numpy()
        want = np.asarray(getattr(ref, key))
        assert got.shape == want.shape, key
        # bitwise for the POU and multiplicities; index dtypes differ
        # (int64 here, int32 there) but not their values
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert dec.d.numpy().tobytes() == np.asarray(ref.d).tobytes()


@pytest.mark.parametrize("fmt", ["auto", "dia", "ell", "dense"])
@pytest.mark.parametrize("S,Nx,Ny", CONFIGS)
def test_pack_local_matrices_equal(S, Nx, Ny, fmt):
    ref_gen, gen = _gen_pair(S, Nx, Ny)
    n_max = max(gen.n_loc)
    ref = jax_pack(ref_gen.mats, n_max=n_max, fmt=fmt)
    got = pack_local_matrices(gen.mats, n_max=n_max, fmt=fmt, device="cpu")
    assert type(got).__name__ == type(ref).__name__
    # an ELL batch is stored slot-major: the transpose of the JAX layout
    vals = got.values.transpose(1, 2) if type(got).__name__ == "BatchedELL" \
        else got.values
    assert vals.contiguous().numpy().tobytes() == \
        np.asarray(ref.values).tobytes()
    if fmt == "ell":
        assert got.cols.transpose(1, 2).contiguous().numpy().tobytes() == \
            np.asarray(ref.cols).tobytes()
    elif fmt != "dense":
        assert got.offsets == ref.offsets
        assert got.values.is_contiguous()


COMMAND_LINES = [
    ["-hpddm_tol", "1e-8", "-hpddm_schwarz_method=ras",
     "-hpddm_schwarz_coarse_correction", "deflated", "-hpddm_geneo_nu", "10"],
    ["-hpddm_gmres_restart=20", "-hpddm_max_it", "250", "-hpddm_verbosity",
     "-hpddm_orthogonalization", "cgs2", "-hpddm_level_2_p", "2"],
    ["-hpddm_push_prefix", "mine_", "-hpddm_tol", "1e-4", "-hpddm_pop_prefix",
     "-hpddm_geneo_threshold", "0.3", "-hpddm_mumps_icntl_24", "1",
     "-N", "8", "-Nx", "64"],
]


@pytest.mark.parametrize("argv", COMMAND_LINES)
def test_options_parse_equal(argv):
    app = [("N=<4>", "subdomains"), ("Nx=<100>", "grid")]
    ref = JaxOptions.parse(argv, display=False, app_options=app)
    got = Options.parse(argv, display=False, app_options=app)
    assert dict(got.items()) == dict(ref.items())
    assert got.app() == ref.app()
    for key in ("tol", "max_it", "gmres_restart", "schwarz_method",
                "orthogonalization", "geneo_nu", "verbosity"):
        assert got.val(key) == ref.val(key), key
        assert got.val(key, prefix="mine_") == ref.val(key, prefix="mine_")
    assert got.set("tol") == ref.set("tol")
    assert got.level(2).val("p") == ref.level(2).val("p")
    assert got.level(2).val("tol") == ref.level(2).val("tol")


def test_options_reject_like_reference():
    with pytest.raises(ValueError):
        Options(schwarz_method="bogus")
    with pytest.raises(ValueError):
        Options.parse(["-hpddm_max_it", "0"], display=False)


def test_decomposition_on_device_argument():
    gen = diffusion2d.generate(4, 20, 20, overlap=1)
    dec = Decomposition.from_subdomains(gen.neighbors, gen.mappings,
                                        gen.n_loc, d=gen.d,
                                        device=torch.device("cpu"))
    assert dec.device.type == "cpu" and dec.d.dtype == torch.float64
    assert not dec.renumbered and dec.perm is None
    ren = Decomposition.from_subdomains(gen.neighbors, gen.mappings,
                                        gen.n_loc, d=gen.d, renumber=True,
                                        device="cpu")
    assert ren.renumbered and ren.perm.device.type == "cpu"
    assert ren.perm.dtype == ren.iperm.dtype == torch.int64
