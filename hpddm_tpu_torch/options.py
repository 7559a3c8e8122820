"""Runtime option system (counterpart of ``hpddm_tpu/options.py``).

The same registry and parser as the JAX package, without its imports, so
that ``-hpddm_*`` command lines parse to the same values. Re-design of
HPDDM's ``Option`` singleton
(reference: include/HPDDM_option.hpp:43-386, include/HPDDM_option_impl.hpp:44-183):
a string-keyed map with

* registered options with defaults, enum alternatives ``key=(a|b|c)``,
  numeric options ``key=<val>``,
* per-object prefixes (``-hpddm_myprefix_...``) and per-level prefixes
  ``level_N_`` (regex ``HPDDM_REGEX_LEVEL``, HPDDM_option_impl.hpp:27),
* command-line / config-file / keyword parsing and an auto-generated help.

Unlike the reference we keep values as Python objects (str for enum options,
float for numerics) rather than packing everything into doubles, but `val()`
accessors mirror the C++ behaviour (enum -> index available through
`enum_index`).
"""

from __future__ import annotations

import re
import sys
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Registered options: name -> (kind, default, alternatives, help)
# kind in {"numeric", "positive", "integer", "enum", "flag", "argument"}
# Mirrors the table at HPDDM_option_impl.hpp:44-183.
_LEVEL_RE = re.compile(r"^level_([2-9]\d*)_(.*)$")

_REGISTRY: Dict[str, Tuple[str, Any, Optional[Tuple[str, ...]], str]] = {
    "help": ("flag", None, None, "Display available options"),
    "version": ("flag", None, None, "Display information about hpddm_tpu"),
    "config_file": ("argument", None, None, "Load options from a file saved on disk"),
    "tol": ("numeric", 1.0e-6, None, "Relative decrease in residual norm"),
    "max_it": ("positive", 100, None, "Maximum number of iterations"),
    "verbosity": ("integer", 0, None, "Level of output"),
    "compute_residual": ("enum", None, ("l2", "l1", "linfty"),
                         "Print the residual after convergence"),
    "reuse_preconditioner": ("integer", 0, None,
                             "Do not factorize again the local matrices for subsequent solves"),
    "operator_spd": ("integer", 0, None, "Assume the operator is SPD"),
    "orthogonalization": ("enum", "cgs", ("cgs", "mgs", "cgs2"),
                          "Classical, Modified, or iterated-Classical "
                          "Gram-Schmidt (cgs2: one extra fused Gram pass — "
                          "the f32 default, restores orthogonality over "
                          "long bases at one extra psum)"),
    "dump_matrices": ("argument", None, None, "Save all local matrices to disk"),
    "dump_eigenvectors": ("argument", None, None, "Save all local eigenvectors to disk"),
    "krylov_method": ("enum", "gmres",
                      ("gmres", "bgmres", "cg", "bcg", "gcrodr", "bgcrodr",
                       "bfbcg", "richardson", "none"),
                      "Krylov method"),
    "enlarge_krylov_subspace": ("positive", None, None,
                                "Split the initial right-hand side into multiple vectors"),
    "gmres_restart": ("positive", 40, None,
                      "Maximum number of Arnoldi vectors generated per cycle"),
    "variant": ("enum", "right", ("left", "right", "flexible"),
                "Left, right, or variable preconditioning"),
    "qr": ("enum", "cholqr", ("cholqr", "cgs", "mgs"), "Distributed QR factorization"),
    "deflation_tol": ("numeric", None, None,
                      "Tolerance when deflating right-hand sides inside block methods"),
    "recycle": ("positive", None, None, "Number of harmonic Ritz vectors to compute"),
    "recycle_same_system": ("integer", 0, None,
                            "Assume the system is the same as the one already recycled"),
    "recycle_strategy": ("enum", "A", ("A", "B"),
                         "Generalized eigenvalue problem to solve for recycling"),
    "recycle_target": ("enum", "SM", ("SM", "LM", "SR", "LR", "SI", "LI"),
                       "Criterion to select harmonic Ritz vectors"),
    "richardson_damping_factor": ("numeric", 1.0, None, "Richardson damping factor"),
    # Overlapping Schwarz
    "schwarz_method": ("enum", "ras", ("ras", "oras", "soras", "asm", "osm", "none"),
                       "Schwarz variant"),
    "schwarz_coarse_correction": ("enum", None, ("deflated", "additive", "balanced"),
                                  "Switch to a multilevel preconditioner"),
    # Substructuring
    "substructuring_scaling": ("enum", "multiplicity",
                               ("multiplicity", "stiffness", "coefficient"),
                               "Scaling used for the FETI/BDD preconditioner"),
    "substructuring_coarse": ("enum", "dense", ("dense", "mfree", "cheby"),
                              "FETI/BDD coarse solves: dense = replicated "
                              "G + dense factorization; mfree = matrix-"
                              "free G/W applies with the exact (small) "
                              "coarse matrix assembled slot-wise (scales "
                              "past nc ~ 1e4, exact iteration parity); "
                              "cheby = fully matrix-free fixed-degree "
                              "Chebyshev (approximate; best for BDD or "
                              "moderate subdomain counts)"),
    "substructuring_coarse_degree": ("integer", None, None,
                                     "Chebyshev degree of the matrix-free "
                                     "substructuring coarse solves (default: "
                                     "from the estimated condition number)"),
    "substructuring_local": ("enum", "dense", ("dense", "banded"),
                             "FETI/BDD local solves: dense = batched "
                             "eigh pseudo-inverses (O(n^2) memory); "
                             "banded = matrix-free block-tridiagonal LU "
                             "for grid subdomains (K^+ = projected "
                             "regularized solve + refinement, implicit "
                             "Schur applies, Chebyshev S^+; O(n*wx) "
                             "memory, needs analytic kernels)"),
    "substructuring_refine": ("integer", 2, None,
                              "Residual-refinement passes of the banded "
                              "K^+ applies"),
    "substructuring_local_degree": ("integer", None, None,
                                    "Chebyshev degree of the banded-mode "
                                    "S_b^+ (default: from the estimated "
                                    "condition number)"),
    # GenEO
    "eigensolver_tol": ("numeric", 1.0e-6, None, "Tolerance of the local eigensolver"),
    "geneo_nu": ("integer", 20, None,
                 "Number of local eigenvectors to compute for adaptive methods"),
    "geneo_threshold": ("numeric", None, None,
                        "Threshold for selecting local eigenvectors"),
    "geneo_estimate_nu": ("integer", 0, None,
                          "Estimate the number of eigenvalues below a threshold"),
    "geneo_force_uniformity": ("enum", None, ("min", "max"),
                               "Force the same number of local vectors on all subdomains"),
    "lanczos_ncv": ("integer", None, None,
                    "Number of Lanczos basis vectors per shift-invert restart "
                    "(analogue of -hpddm_arpack_ncv)"),
    # Local solver selection (TPU-specific: replaces the SUBDOMAIN compile-time plug-in)
    "local_solver": ("enum", "inv",
                     ("inv", "lu", "chol", "qr", "fft", "cheby", "dst_cheby",
                      "banded"),
                     "Batched local solve strategy on TPU (fft = DST fast "
                     "Poisson for grid subdomains, O(n log n), no factors; "
                     "cheby/dst_cheby = inexact k-step Chebyshev local "
                     "solves, Jacobi- or DST-preconditioned, for large "
                     "heterogeneous subdomains; banded = exact "
                     "block-tridiagonal LU for grid subdomains, O(n*wx) "
                     "factor memory)"),
    "banded_block_rows": ("integer", 1, None,
                          "Grid rows per elimination block of the banded "
                          "local solver (fewer scan steps, r x factor "
                          "memory)"),
    "local_cheby_steps": ("integer", 16, None,
                          "Chebyshev steps per inexact local solve"),
    "local_cheby_power_its": ("integer", 30, None,
                              "Power-iteration steps for the Chebyshev "
                              "spectral bounds (setup)"),
    "coarse_dtype": ("enum", None, ("same", "float32", "bfloat16"),
                     "Precision of the coarse operator (HPDDM_MIXED_PRECISION analogue)"),
    "gmv_dtype": ("enum", None, ("same", "bfloat16"),
                  "Storage precision of the SpMM value planes (hot-path "
                  "HBM stream; accumulation stays in the vector dtype). "
                  "bfloat16 halves the dominant GMV traffic"),
    "coarse_galerkin": ("enum", "multiplication",
                        ("multiplication", "accumulation"),
                        "bsr Galerkin algorithm: interface-slab products "
                        "(MatrixMultiplication) or per-subdomain partial "
                        "overlap contributions additively reduced "
                        "(MatrixAccumulation)"),
    "coarse_assembly": ("enum", "dense", ("dense", "bsr"),
                        "Coarse operator E: dense replicated assembly and "
                        "solve, or neighbor-block-sparse (the reference's "
                        "sparsity pattern 's') with distributed block "
                        "matvecs — O(S*neighbors) memory, scales to "
                        "thousands of subdomains"),
}

# Options that are parsed and accepted for reference compatibility but have
# no effect on this backend: a TPU mesh has no heterogeneous ranks, so the
# main-process count/topology/exclusion and the user->solver redistribution
# knobs of the reference's coarse gather/scatter are structural no-ops
# (VERDICT r1: a user sweeping reference flags must get a signal).
_INERT_LEVEL_KEYS = frozenset(
    {"p", "topology", "exclude", "distribution", "assembly_hierarchy"})

# Options valid under a level_N_ prefix (coarse levels), cf. cheatsheet/option table.
_LEVEL_REGISTRY: Dict[str, Tuple[str, Any, Optional[Tuple[str, ...]], str]] = {
    "p": ("positive", 1, None, "Number of main processes"),
    "distribution": ("enum", "centralized", ("centralized", "sol"),
                     "Distribution of coarse right-hand sides and solutions"),
    "topology": ("enum", "0", ("0", "1", "2"), "Distribution of the main processes"),
    "assembly_hierarchy": ("positive", None, None, "Assembly hierarchy of the coarse operator"),
    "aggregate_size": ("positive", None, None, "Mains per sub-communicator"),
    "dump_matrix": ("argument", None, None, "Save the coarse operator to disk"),
    "exclude": ("integer", 0, None, "Exclude mains from the domain decomposition"),
    # Krylov knobs are also honoured on coarse levels (recursive solves).
    "tol": ("numeric", 1.0e-2, None, "Coarse relative tolerance"),
    "max_it": ("positive", 100, None, "Coarse max iterations"),
    "krylov_method": _REGISTRY["krylov_method"],
    "gmres_restart": _REGISTRY["gmres_restart"],
    "schwarz_method": _REGISTRY["schwarz_method"],
    "verbosity": ("integer", 0, None, "Coarse verbosity"),
}


class Options:
    """String-keyed option map with prefix support.

    ``Options(tol=1e-8, schwarz_method="ras")`` or
    ``Options.parse(["-hpddm_tol", "1e-8", "-hpddm_schwarz_method=ras"])``.

    Per-level options: ``opt["level_2_p"] = 2`` or ``opt.level(2)["p"]``.
    Per-object prefixes (HPDDM ``setPrefix``): pass ``prefix=`` to accessors,
    e.g. ``opt.val("tol", prefix="mine_")`` falls back to the unprefixed key.
    """

    def __init__(self, **kwargs: Any):
        self._map: Dict[str, Any] = {}
        self._app: Dict[str, Any] = {}
        # per-prefix recycled-subspace store (GCRO-DR (U, C) pairs): the
        # analogue of OptionsPrefix::storage_ (HPDDM_option.hpp:444-461).
        # Shared (not copied) across .copy() so recycling survives the
        # defensive copies the dispatch makes.
        self._storage: Dict[str, Any] = {}
        for key, value in kwargs.items():
            self[key] = value

    # -- recycled-subspace storage (OptionsPrefix::storage_) ---------------
    def storage(self, prefix: str = "") -> Any:
        """Recycled space stored under `prefix` (None if absent)."""
        return self._storage.get(prefix)

    def set_storage(self, value: Any, prefix: str = "") -> None:
        self._storage[prefix] = value

    def clear_storage(self, prefix: str = "") -> None:
        self._storage.pop(prefix, None)

    # -- dict-like core ---------------------------------------------------
    @staticmethod
    def _registry_for(key: str):
        m = _LEVEL_RE.match(key)
        if m:
            return _LEVEL_REGISTRY.get(m.group(2))
        return _REGISTRY.get(key)

    def _coerce(self, key: str, value: Any) -> Any:
        reg = self._registry_for(key)
        if reg is None:
            return value
        kind, _, alts, _ = reg
        if kind == "enum":
            value = str(value)
            if alts is not None and value not in alts:
                raise ValueError(
                    f"option {key!r}: invalid value {value!r}, expected one of {alts}")
            return value
        if kind in ("integer", "positive"):
            iv = int(value)
            if kind == "positive" and iv <= 0:
                raise ValueError(f"option {key!r}: expected a positive value, got {iv}")
            return iv
        if kind == "numeric":
            return float(value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        self._map[key] = self._coerce(key, value)

    def __getitem__(self, key: str) -> Any:
        return self._map[key]

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def __delitem__(self, key: str) -> None:
        del self._map[key]

    def remove(self, key: str) -> None:
        self._map.pop(key, None)

    def set(self, key: str, prefix: str = "") -> bool:
        """HPDDM ``opt.set(key)``: is the option explicitly present?"""
        return (prefix + key) in self._map or (prefix and key in self._map)

    def val(self, key: str, default: Any = None, prefix: str = "") -> Any:
        """Value with prefix fallback, then registered default, then `default`."""
        if prefix and (prefix + key) in self._map:
            return self._map[prefix + key]
        if key in self._map:
            return self._map[key]
        if default is not None:
            return default
        reg = self._registry_for(key)
        if reg is not None and reg[1] is not None:
            return reg[1]
        return default

    def enum_index(self, key: str, default: Any = None, prefix: str = "") -> Optional[int]:
        """Index of an enum option among its alternatives (the C++ stored value)."""
        reg = self._registry_for(key)
        v = self.val(key, default, prefix)
        if v is None or reg is None or reg[2] is None:
            return None
        return reg[2].index(v)

    def level(self, n: int) -> "_LevelView":
        return _LevelView(self, n)

    def app(self) -> Dict[str, Any]:
        """Application-registered options (HPDDM ``opt.app()``)."""
        return self._app

    def items(self):
        return self._map.items()

    def copy(self) -> "Options":
        o = Options()
        o._map = dict(self._map)
        o._app = dict(self._app)
        o._storage = self._storage          # shared: it is a cache
        return o

    def inert_notices(self) -> List[str]:
        """Human-readable notices for set options that are accepted for
        reference compatibility but have no effect on this backend."""
        out = []
        for key in sorted(self._map):
            m = _LEVEL_RE.match(key)
            if m and m.group(2) in _INERT_LEVEL_KEYS:
                out.append(
                    f"note: -hpddm_{key} accepted but inert on this backend "
                    "(no heterogeneous ranks / main processes on a TPU mesh)")
        return out

    def warn_inert(self) -> None:
        """Print inert-option notices once (at verbosity >= 1)."""
        if int(self.val("verbosity", 0)) < 1 or getattr(
                self, "_inert_warned", False):
            return
        for line in self.inert_notices():
            print(line)
        self._inert_warned = True

    def rename_level(self, src: int, dst: int) -> "Options":
        """Shift level prefixes: the reference renames ``level_2_*`` options when
        recursing (HPDDM_preconditioner.hpp:190-213). Returns a new Options whose
        ``level_{src}_x`` appear as ``level_{dst}_x`` (and top-level semantics kept)."""
        o = self.copy()
        for key in list(o._map):
            m = _LEVEL_RE.match(key)
            if m and int(m.group(1)) == src:
                o._map[f"level_{dst}_{m.group(2)}"] = o._map.pop(key)
        return o

    # -- parsing ----------------------------------------------------------
    PREFIX = "-hpddm_"

    @classmethod
    def parse(cls, args: Optional[Sequence[str]] = None,
              display: bool = True,
              app_options: Optional[Iterable[Tuple[str, str]]] = None,
              **kwargs: Any) -> "Options":
        """Parse ``-hpddm_key[=val]`` command-line arguments (and ``-key`` app
        options registered via `app_options` = iterable of (spec, help)).

        Mirrors Option::parse (HPDDM_option_impl.hpp:225-268): ``key=val``,
        ``key val``, bare flags, and ``-hpddm_config_file=<path>`` with one
        option per line.
        """
        opt = cls(**kwargs)
        if args is None:
            args = sys.argv[1:]
        app_specs: Dict[str, str] = {}
        for spec, _help in (app_options or ()):  # spec like "Nx=<100>" or "symmetric_csr=(0|1)"
            name = re.split(r"[=(]", spec, 1)[0]
            app_specs[name] = spec
            m = re.search(r"=<([^>]*)>", spec)
            if m and m.group(1):
                # numeric <...> contents are defaults; non-numeric ones are
                # placeholders like <input_file> (Arg::argument) — no default
                try:
                    opt._app[name] = int(m.group(1))
                except ValueError:
                    try:
                        opt._app[name] = float(m.group(1))
                    except ValueError:
                        pass
        tokens: List[str] = list(args)
        i = 0
        cur_prefix = ""          # -hpddm_push_prefix X ... -hpddm_pop_prefix
        while i < len(tokens):
            tok = tokens[i]
            i += 1
            if not tok.startswith("-"):
                continue
            body = tok.lstrip("-")
            is_hpddm = body.startswith("hpddm_")
            if is_hpddm:
                body = body[len("hpddm_"):]
            if is_hpddm and body.startswith("push_prefix"):
                if "=" in body:
                    cur_prefix = body.split("=", 1)[1]
                elif i < len(tokens) and not tokens[i].startswith("-"):
                    cur_prefix = tokens[i]
                    i += 1
                continue
            if is_hpddm and body == "pop_prefix":
                cur_prefix = ""
                continue
            if is_hpddm and cur_prefix:
                body = cur_prefix + body
            if "=" in body:
                key, value = body.split("=", 1)
            else:
                key = body
                value = None
                if i < len(tokens) and not tokens[i].startswith("-"):
                    value = tokens[i]
                    i += 1
            if is_hpddm:
                if key == "config_file" and value:
                    opt._parse_config_file(value)
                    continue
                reg = cls._registry_for(key)
                if reg is None:
                    # accept unknown keys verbatim (backend passthrough e.g. mumps_icntl_*)
                    opt._map[key] = _auto(value)
                elif reg[0] == "flag":
                    opt._map[key] = True
                    if key == "help" and display:
                        print(cls.help_text())
                    if key == "version" and display:
                        print(cls.version_text())
                else:
                    opt[key] = _auto(value) if value is not None else 1
            else:
                if key in app_specs:
                    opt._app[key] = _auto(value) if value is not None else 1
        return opt

    def _parse_config_file(self, path: str) -> None:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if "=" in line:
                    key, value = line.split("=", 1)
                else:
                    parts = line.split(None, 1)
                    key, value = parts[0], (parts[1] if len(parts) > 1 else None)
                key = key.strip().lstrip("-")
                if key.startswith("hpddm_"):
                    key = key[len("hpddm_"):]
                reg = self._registry_for(key)
                if reg is None:
                    self._map[key] = _auto(value)
                else:
                    self[key] = _auto(value) if value is not None else 1

    # -- reporting --------------------------------------------------------
    @staticmethod
    def help_text() -> str:
        lines = ["Available options (prefix -hpddm_):"]
        for name, (kind, default, alts, help_) in _REGISTRY.items():
            if kind == "enum" and alts:
                spec = f"{name}=({'|'.join(alts)})"
            elif kind == "flag":
                spec = name
            else:
                spec = f"{name}=<{default if default is not None else 'val'}>"
            lines.append(f"  -hpddm_{spec:<55} {help_}")
        lines.append(" Coarse-level options (prefix -hpddm_level_N_, N >= 2):")
        for name, (kind, default, alts, help_) in _LEVEL_REGISTRY.items():
            if kind == "enum" and alts:
                spec = f"{name}=({'|'.join(alts)})"
            else:
                spec = f"{name}=<{default if default is not None else 'val'}>"
            lines.append(f"  -hpddm_level_N_{spec:<48} {help_}")
        return "\n".join(lines)

    @staticmethod
    def version_text() -> str:
        import torch
        from hpddm_tpu_torch import __version__
        cuda = torch.version.cuda or "none"
        return (f"hpddm_tpu_torch {__version__} — domain decomposition on "
                f"PyTorch (torch {torch.__version__}, CUDA {cuda}, "
                f"{torch.cuda.device_count()} GPU(s))")

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in sorted(self._map.items()))
        return f"Options({inner})"


class _LevelView:
    """View over ``level_N_``-prefixed options (HPDDM_REGEX_LEVEL analogue)."""

    def __init__(self, opt: Options, n: int):
        self._opt = opt
        self._n = int(n)
        if self._n < 2:
            raise ValueError("coarse levels are numbered from 2")

    def _key(self, key: str) -> str:
        return f"level_{self._n}_{key}"

    def __getitem__(self, key: str) -> Any:
        return self._opt[self._key(key)]

    def __setitem__(self, key: str, value: Any) -> None:
        self._opt[self._key(key)] = value

    def __contains__(self, key: str) -> bool:
        return self._key(key) in self._opt

    def val(self, key: str, default: Any = None) -> Any:
        if self._key(key) in self._opt:
            return self._opt[self._key(key)]
        reg = _LEVEL_REGISTRY.get(key)
        if default is None and reg is not None and reg[1] is not None:
            return reg[1]
        return default


def _auto(value: Optional[str]) -> Any:
    """Best-effort str -> int/float/str conversion."""
    if value is None:
        return 1
    if isinstance(value, (int, float, bool)):
        return value
    try:
        return int(value)
    except (TypeError, ValueError):
        pass
    try:
        return float(value)
    except (TypeError, ValueError):
        pass
    return value
