"""The port's execution-trace debugger (`loader/evm_debug.py`) against a
plain run of the port's interpreter and against the JAX package's tracer on
the same Yul: the same steps, gas, reports, search and `tui` session.
Host code on both sides."""

import io

import pytest
import torch

from snark_verifier_tpu.loader import evm_debug as jdbg

from snark_verifier_tpu_torch.loader.evm_debug import debug_yul, unparse
from snark_verifier_tpu_torch.loader.yul_interp import execute_yul
from snark_verifier_tpu_torch.sdk.evm import encode_calldata, gen_evm_verifier
from snark_verifier_tpu_torch.sdk.proof_io import proof_to_bytes
from snark_verifier_tpu_torch.sdk.snark import Snark
from snark_verifier_tpu_torch.sdk.srs import toy_srs
from snark_verifier_tpu_torch.system.standard_plonk import StandardPlonk, build_protocol, prove
from snark_verifier_tpu_torch.transcript.evm_transcript import EvmTranscriptPy

torch.set_num_threads(1)

SRC = """object "t" { object "Runtime" { code {
    function sq(x) -> y { y := mulmod(x, x, 97) }
    let a := calldataload(0)
    let b := sq(a)
    let c := sq(b)
    mstore(0x00, addmod(b, c, 97))
    return(0x00, 0x20)
} } }"""


def _same_trace(tr, jtr):
    """Every recorded step, the totals and the per-function and precompile
    gas equal the JAX tracer's."""
    assert (tr.success, tr.gas_used, tr.returndata, tr.truncated) == \
        (jtr.success, jtr.gas_used, jtr.returndata, jtr.truncated)
    assert [s.__dict__ for s in tr.steps] == [s.__dict__ for s in jtr.steps]
    assert {k: v.__dict__ for k, v in tr.fun_stats.items()} == \
        {k: v.__dict__ for k, v in jtr.fun_stats.items()}
    assert tr.precompile_calls == jtr.precompile_calls
    assert tr.gas_report() == jtr.gas_report()
    assert tr.render(0, 50) == jtr.render(0, 50)


@pytest.mark.parametrize("a", [5, 3, 0])
def test_trace_steps_and_gas_match_plain_run_and_the_jax_tracer(a):
    cd = a.to_bytes(32, "big")
    tr = debug_yul(SRC, cd)
    ok, gas, data = execute_yul(SRC, cd)
    assert tr.success == ok and tr.gas_used == gas and tr.returndata == data
    b = a * a % 97
    assert int.from_bytes(tr.returndata, "big") == (b + b * b % 97) % 97
    lets = [s for s in tr.steps if s.text.startswith("let b")]
    assert len(lets) == 1 and lets[0].writes == {"b": b}
    assert lets[0].gas_cost > 0
    st = tr.fun_stats["sq"]
    assert st.calls == 2 and st.total_gas >= st.self_gas > 0
    _same_trace(tr, jdbg.debug_yul(SRC, cd))


def test_reports_and_search():
    tr = debug_yul(SRC, (3).to_bytes(32, "big"))
    rep = tr.gas_report()
    assert "sq" in rep and "TOTAL" in rep
    assert "let a := calldataload(0)" in tr.render(0, 10)
    idx = tr.find(r"addmod")
    assert idx is not None and "addmod" in tr.steps[idx].text
    assert tr.find(r"no_such_fn") is None
    jtr = jdbg.debug_yul(SRC, (3).to_bytes(32, "big"))
    assert [tr.find(p, after) for p in ("sq", "mstore", "mulmod") for after in (0, 2, 5)] == \
        [jtr.find(p, after) for p in ("sq", "mstore", "mulmod") for after in (0, 2, 5)]


def test_tui_stream_session():
    script = "n\np\nj 2\n/mulmod\ng\nj x\n/(\nzz\nq\n"
    out, jout = io.StringIO(), io.StringIO()
    debug_yul(SRC, (2).to_bytes(32, "big")).tui(inp=io.StringIO(script), out=out, page=3)
    jdbg.debug_yul(SRC, (2).to_bytes(32, "big")).tui(inp=io.StringIO(script), out=jout, page=3)
    text = out.getvalue()
    assert "yul debugger:" in text and "OK" in text
    assert "TOTAL" in text  # the gas report printed by 'g'
    assert "usage: j <step-number>" in text and "bad pattern" in text
    assert text == jout.getvalue()


def test_unparse_shapes():
    for e in (("let", ["x"], ("call", "add", [("num", 1), ("var", "y")])),
              ("assign", ["a", "b"], ("call", "f", [])),
              ("if", ("var", "c"), ("block", [])),
              ("expr", ("call", "mstore", [("num", 1 << 20), ("num", 7)])),
              ("fun", "g", ["p"], ["q"], ("block", []))):
        assert unparse(e) == jdbg.unparse(e)
    assert unparse(("let", ["x"], ("call", "add", [("num", 1), ("var", "y")]))) \
        == "let x := add(1, y)"
    assert unparse(("assign", ["a", "b"], ("call", "f", []))) == "a, b := f()"


def test_debug_generated_verifier():
    """A generated verifier traced end to end: the tracer agrees with the
    plain interpreter and with the JAX tracer on the verdict, the gas and
    every step, with exactly one pairing call."""
    srs = toy_srs(64)
    circ = StandardPlonk.rand(k=4, seed=11)
    protocol = build_protocol(circ, srs, device="cpu")
    scalars, points = prove(circ, protocol, srs, scheme="shplonk", transcript=EvmTranscriptPy(),
                            device="cpu")
    snark = Snark(protocol, [list(circ.instance)], scalars, points)
    yul = gen_evm_verifier(protocol, srs, "shplonk")
    cd = encode_calldata(snark.instances, proof_to_bytes(snark, "shplonk", fmt="evm"))
    tr = debug_yul(yul, cd)
    ok, gas, _ = execute_yul(yul, cd)
    assert tr.success and ok and tr.gas_used == gas
    pairings = [g for addr, g in tr.precompile_calls if addr == 8]
    assert len(pairings) == 1 and pairings[0] >= 45000
    assert "ecPairing" in tr.gas_report()
    _same_trace(tr, jdbg.debug_yul(yul, cd))
