"""The port's large-circuit memory governors against the JAX package's.

The JAX package bounds the memory of a large prove with four switches
(README "memory governors for large circuits"; its own test is
tests/test_tpu_engine.py::test_chunked_memory_paths_byte_identical):
BPT_EVAL_CHUNK (round 4's evaluations in position chunks), BPT_COMBINE_CHUNK
(round 5's linear combination in position chunks), BPT_R3_CONSTS_BYTES and
BPT_R3_ROWCACHE_BYTES (round 3's constants and its nine coset rows cached
only under a byte budget). The port holds them as module constants:
``dpoly.EVAL_CHUNK``, ``prover_kernels.COMBINE_CHUNK`` and the shares of the
device's memory ``prover_kernels.R3_CONSTS_SHARE`` and ``R3_ROWCACHE_SHARE``.
Here tiny thresholds force every chunk edge at test sizes; the same inputs,
made with numpy from a seed, go through the JAX function under the same
setting (its variables set in the environment) and through the port (its
constants patched), and the port's chunked result is also held against its
own single-shot one. Tolerance: exact (field elements and proof bytes)."""
import pytest

from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops import dpoly, limbs, prover_kernels
from baby_plonk_tpu_torch.ops.dpoly import DPoly, eval_many
from baby_plonk_tpu_torch.ops.prover_kernels import linear_combine_device
from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
from baby_plonk_tpu_torch.protocol import Program, Prover, Setup
from baby_plonk_tpu_torch.protocol.poly import Basis

from torch_port_util import field_ints, one_torch_thread  # noqa: F401  (fixture)

Q = fr.Q
W = 8
#: the circuit and witness of tests/test_tpu_engine.py:57-62
CIRCUIT = ["e public", "c <== a * b + b", "e <== c * d"]
WITNESS = {"a": 3, "b": 4, "c": 16, "d": 5, "e": 80}
BLINDING = list(range(1, 12))
#: each JAX variable and the port's constant that takes its place
PORT = {"BPT_EVAL_CHUNK": (dpoly, "EVAL_CHUNK"), "BPT_COMBINE_CHUNK": (prover_kernels, "COMBINE_CHUNK"),
        "BPT_R3_CONSTS_BYTES": (prover_kernels, "R3_CONSTS_SHARE"),
        "BPT_R3_ROWCACHE_BYTES": (prover_kernels, "R3_ROWCACHE_SHARE")}
FORCED = {"BPT_EVAL_CHUNK": W, "BPT_COMBINE_CHUNK": W, "BPT_R3_CONSTS_BYTES": 0, "BPT_R3_ROWCACHE_BYTES": 0}


def _use(monkeypatch, settings: dict):
    """Both packages under ``settings``: the JAX package reads its variables
    at each call, the port its constants (a budget of 0 is a share of 0)."""
    for k, v in settings.items():
        monkeypatch.setenv(k, str(v))
        monkeypatch.setattr(*PORT[k], v)


def _polys(lengths, seed):
    return [field_ints(seed + i, Q, n) for i, n in enumerate(lengths)]


def _port(values):
    return [DPoly.from_ints(v, Basis.MONOMIAL, "cpu") for v in values]


def _jax(values):
    from baby_plonk_tpu.ops.dpoly import DPoly as JDPoly
    from baby_plonk_tpu.protocol.poly import Basis as JBasis

    return [JDPoly.from_ints(v, JBasis.MONOMIAL) for v in values]


#: stacks whose longest polynomial crosses 1, 2 and 3 chunk edges at W = 8,
#: shorter ones beside it (one of them inside the first chunk)
STACKS = [(9,), (17, 5), (25, 9, 3, 17)]
EDGES = ["1-edge", "2-edges", "3-edges"]


@pytest.mark.parametrize("lengths", STACKS, ids=EDGES)
def test_eval_many_chunked_matches_jax(monkeypatch, lengths):
    from baby_plonk_tpu.ops.dpoly import eval_many as jax_eval_many

    values = _polys(lengths, 100 + len(lengths))
    x = field_ints(7, Q, 1)[0]
    before = eval_many.chunks
    single = eval_many(_port(values), x)
    assert eval_many.chunks == before + 1, "below EVAL_CHUNK one stacked multiply"
    widths = []
    real = limbs.pow_table
    monkeypatch.setattr(limbs, "pow_table", lambda spec, z, n, **kw: widths.append(n) or real(spec, z, n, **kw))
    _use(monkeypatch, {"BPT_EVAL_CHUNK": W})
    chunked = eval_many(_port(values), x)
    assert widths == [W], "the chunked evaluation uses one power table of the chunk's width"
    assert eval_many.chunks == before + 1 + -(-max(lengths) // W)
    want = jax_eval_many(_jax(values), x)
    host = [sum(c * pow(x, i, Q) for i, c in enumerate(v)) % Q for v in values]
    assert chunked == want == single == host


@pytest.mark.parametrize("lengths", STACKS + [(24, 16, 1)], ids=EDGES + ["3-edges-exact"])
def test_linear_combine_chunked_matches_jax(monkeypatch, lengths):
    from baby_plonk_tpu.ops.prover_kernels import linear_combine_device as jax_combine

    values = _polys(lengths, 200 + len(lengths))
    coeffs = field_ints(31, Q, len(lengths))
    const = field_ints(32, Q, 1)[0]
    before = linear_combine_device.chunks
    single = linear_combine_device(_port(values), coeffs, const).values
    assert linear_combine_device.chunks == before + 1, "below COMBINE_CHUNK one stacked multiply"
    _use(monkeypatch, {"BPT_COMBINE_CHUNK": W})
    got = linear_combine_device(_port(values), coeffs, const)
    m = max(lengths)
    assert linear_combine_device.chunks == before + 1 + -(-m // W), "one combine a chunk of positions"
    want = jax_combine(_jax(values), coeffs, const).values
    host = [(sum(c * (v[i] if i < len(v) else 0) for c, v in zip(coeffs, values)) + (const if i == 0 else 0)) % Q
            for i in range(m)]
    assert got.values == want == single == host


@pytest.mark.parametrize("slack", [0, -1], ids=["at-budget", "one-byte-short"])
def test_round3_consts_cached_only_within_budget(monkeypatch, slack):
    m = 32
    monkeypatch.setattr(prover_kernels, "_R3_CONSTS", {})
    monkeypatch.setattr(prover_kernels, "R3_CONSTS_SHARE", 1)
    monkeypatch.setattr(prover_kernels, "_memory_bytes", lambda device: 4 * m * 64 + slack)
    first = prover_kernels._round3_consts(m, "cpu")
    assert ((m, "cpu") in prover_kernels._R3_CONSTS) == (slack == 0)
    again = prover_kernels._round3_consts(m, "cpu")
    assert (again is first) == (slack == 0)
    assert all(a.equal(b) for a, b in zip(first, again))


def test_forced_governors_prove_equals_jax_host_engine(monkeypatch):
    """The counterpart of the JAX package's
    test_chunked_memory_paths_byte_identical: a port prove at n = 8 with all
    four governors forced (chunks of 8, both budgets 0) gives the JAX
    HostEngine's proof bytes under the same blinding; neither round-3 cache
    holds anything after it, and a second prove recomputes both to the same
    bytes."""
    from baby_plonk_tpu.ops.engine import HostEngine as JHostEngine
    from baby_plonk_tpu.protocol.program import Program as JProgram
    from baby_plonk_tpu.protocol.prover import Prover as JProver
    from baby_plonk_tpu.protocol.setup import Setup as JSetup

    _use(monkeypatch, FORCED)
    monkeypatch.setattr(prover_kernels, "_R3_CONSTS", {})
    n = 8
    setup = Setup.generate_srs(n + 6, tau=101, cache=False)
    program = Program.from_strs(CIRCUIT, n)
    engine = TorchEngine("cpu")
    proof = Prover(setup, program, engine=engine).prove(WITNESS, blinding=BLINDING)
    assert program.common_preprocessed_input().coset_rows is None
    assert prover_kernels._R3_CONSTS == {}
    again = Prover(setup, program, engine=engine).prove(WITNESS, blinding=BLINDING)
    jsetup = JSetup.generate_srs(n + 6, tau=101, cache=False)
    jprogram = JProgram.from_strs(CIRCUIT, n)
    want = JProver(jsetup, jprogram, engine=JHostEngine()).prove(WITNESS, blinding=BLINDING)
    assert proof.to_bytes() == again.to_bytes() == want.to_bytes()


def test_default_governors_keep_both_caches(monkeypatch):
    """At the defaults an n = 8 prove runs each round in one piece and keeps
    round 3's constants and coset rows."""
    monkeypatch.setattr(prover_kernels, "_R3_CONSTS", {})
    n = 8
    setup = Setup.generate_srs(n + 6, tau=101, cache=False)
    program = Program.from_strs(CIRCUIT, n)
    Prover(setup, program, engine=TorchEngine("cpu")).prove(WITNESS, blinding=BLINDING)
    assert program.common_preprocessed_input().coset_rows[0] == (4 * n, "cpu")
    assert list(prover_kernels._R3_CONSTS) == [(4 * n, "cpu")]
