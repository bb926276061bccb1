"""The carry-chain Montgomery arithmetic of csrc/fq.cuh, executed on the CPU.

The kernels' field arithmetic is inline PTX whose words are linked by the
carry flag.  No CUDA compiler runs here, so this file reads the asm
statements out of fq.cuh itself and executes them with a small interpreter:
32-bit registers, an explicit carry flag, the operand lists as the source
binds them.  The C++ around the statements (which row follows which, the
reduction digit, the select after a conditional subtract) is mirrored in
python below.  Results are held against python ints kept lazy -- (a·b +
M·p) / R with no final subtraction -- and against the plain version the
kernels are compared with on the card (ff/limb_field.py).

Tolerance: exact.  A statement that reads the flag before setting it, or
whose last instruction drops a carry, fails the test."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from snark_verifier_tpu_torch.ff import FQ, FQ_FIELD, FR, FR_FIELD
from snark_verifier_tpu_torch.ff.spec import int_to_limbs, limbs_to_int

SRC = (Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch" / "csrc"
       / "fq.cuh").read_text()
MASK = 0xFFFFFFFF
R = 1 << 256
SPECS = {"fq": FQ, "fr": FR}
PLAIN = {"fq": FQ_FIELD, "fr": FR_FIELD}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- reading the source


def _tables(fn: str):
    """The two fe_pick(...) literal rows (Fq, Fr) of constexpr function fn."""
    body = SRC[SRC.index(f"constexpr uint32_t {fn}(int k)"):]
    body = body[: body.index("}")]
    rows = re.findall(r"fe_pick\(k,([^)]*)\)", body)
    assert len(rows) == 2
    return {name: [int(w.strip().rstrip("u"), 16) for w in row.split(",")]
            for name, row in zip(("fq", "fr"), rows)}


P_WORDS = _tables("fe_p")
P2_WORDS = _tables("fe_p2")
PINV = dict(zip(("fq", "fr"), (int(x, 16) for x in re.search(
    r"fe_pinv\(\).*?return F == FQ \? (0x[0-9a-f]+)u : (0x[0-9a-f]+)u", SRC, re.S).groups())))


def _asm_of(fn: str):
    """(instructions, outputs, inputs) of the one asm statement of device
    function `fn`: instructions as (opcode, [operands]), operands `%n` or
    immediates; outputs and inputs as (constraint, C expression)."""
    m = re.search(r"\b" + fn + r"\(.*?\)\s*\{", SRC, re.S)
    assert m, fn
    body = SRC[m.end():]
    start = body.index("asm(") + 4
    text = body[start: body.index(");", start)]
    sections, cur, in_str, i = [], "", False, 0
    while i < len(text):
        c = text[i]
        if c == '"':
            in_str = not in_str
        if c == ":" and not in_str:
            sections.append(cur)
            cur = ""
        else:
            cur += c
        i += 1
    sections.append(cur)
    assert len(sections) == 3, fn
    template = "".join(re.findall(r'"([^"]*)"', sections[0])).replace("\\n\\t", "")
    instrs = []
    for line in filter(None, (s.strip() for s in template.split(";"))):
        op, rest = line.split(None, 1)
        instrs.append((op, [t.strip() for t in rest.split(",")]))
    operand = re.compile(r'"([+=]?r)"\(((?:[^()]|\([^()]*\))*)\)')
    outs = operand.findall(sections[1])
    ins = operand.findall(sections[2])
    assert outs, fn
    return instrs, outs, ins


class DroppedCarry(AssertionError):
    pass


def _get(env, expr):
    expr = expr.strip()
    m = re.fullmatch(r"fe_p(2?)<F>\((\d)\)", expr)
    if m:
        return (env["P2"] if m.group(1) else env["P"])[int(m.group(2))]
    if expr == "fe_pinv<F>()":
        return env["PINV"]
    m = re.fullmatch(r"(\w+)\[(\d+)\]", expr)
    if m:
        return env[m.group(1)][int(m.group(2))]
    return env[expr]


def _set(env, expr, val):
    m = re.fullmatch(r"(\w+)\[(\d+)\]", expr.strip())
    if m:
        env[m.group(1)][int(m.group(2))] = val
    else:
        env[expr.strip()] = val


def run_asm(fn: str, env: dict, wraps: bool = False):
    """Execute fn's asm statement on env (C names -> ints or lists of 8).
    `wraps` allows the last instruction to drop a carry (a sum meant mod
    2^256)."""
    instrs, outs, ins = _asm_of(fn)
    regs = [(_get(env, e) if c == "+r" else None) for c, e in outs]
    regs += [_get(env, e) for _, e in ins]
    cf = None  # the carry flag is undefined when a statement starts

    def val(tok):
        if tok.startswith("%"):
            v = regs[int(tok[1:])]
            assert v is not None, f"{fn}: reads an unset output {tok}"
            return v
        return int(tok, 0)

    for op, (dst, *srcs) in instrs:
        parts = op.split(".")
        base, sets_cf = parts[0], "cc" in parts
        reads_cf = base in ("addc", "subc", "madc")
        if reads_cf:
            assert cf is not None, f"{fn}: {op} reads the flag before any .cc set it"
        cin = cf if reads_cf else 0
        x = [val(t) for t in srcs]
        if base in ("add", "addc"):
            full = x[0] + x[1] + cin
        elif base in ("sub", "subc"):
            full = x[0] - x[1] - cin
        elif base in ("mad", "madc"):
            prod = x[0] * x[1]
            full = ((prod >> 32) if "hi" in parts else (prod & MASK)) + x[2] + cin
        elif base == "mul" and "lo" in parts:
            full = (x[0] * x[1]) & MASK  # the low half: nothing to carry
        else:
            raise AssertionError(f"{fn}: unknown opcode {op}")
        out_flag = int(full > MASK or full < 0)
        if sets_cf:
            cf = out_flag
        elif out_flag and base not in ("sub", "subc") and not wraps:
            raise DroppedCarry(f"{fn}: {op} dropped a carry")
        assert dst.startswith("%") and int(dst[1:]) < len(outs), f"{fn}: writes an input"
        regs[int(dst[1:])] = full & MASK
    for k, (_, e) in enumerate(outs):
        assert regs[k] is not None, f"{fn}: output {e} never written"
        _set(env, e, regs[k])


# ------------------------------------------- the C++ around the statements


def words(v):
    return [(v >> (32 * i)) & MASK for i in range(8)]


def unwords(w):
    return sum(x << (32 * i) for i, x in enumerate(w))


def _env(f):
    return {"P": P_WORDS[f], "P2": P2_WORDS[f], "PINV": PINV[f]}


def fe_add8(f, a, b, wraps=False):
    env = dict(_env(f), a=list(a), b=list(b), r=[None] * 8)
    run_asm("fe_add8", env, wraps)
    return env["r"]


def fe_sub8(f, a, b):
    env = dict(_env(f), a=list(a), b=list(b), r=[None] * 8, brw=None)
    run_asm("fe_sub8", env)
    return env["r"], env["brw"]


def fe_cond_sub(f, s, m):
    d, brw = fe_sub8(f, s, m)
    return list(s) if brw else d


def fe_add(f, a, b):
    return fe_cond_sub(f, fe_add8(f, a, b), P2_WORDS[f])


def fe_sub(f, a, b):
    d, brw = fe_sub8(f, a, b)
    assert brw in (0, MASK)
    return fe_add8(f, d, [w & brw for w in P2_WORDS[f]], wraps=bool(brw))


def fe_neg(f, a):
    return fe_sub8(f, P2_WORDS[f], a)[0]


def fe_canon(f, a):
    return fe_cond_sub(f, fe_cond_sub(f, a, P2_WORDS[f]), P_WORDS[f])


def _redc_row(f, e, o):
    m = (e[0] * PINV[f]) & MASK
    run_asm("fe_mad_odd", dict(o=o, a=P_WORDS[f], b=m))  # fe_redc_odd: p's odd words
    run_asm("fe_redc_even", dict(_env(f), e=e, o=o, m=m))
    assert e[0] == 0


def _row(f, e, o, a, b):
    env = dict(_env(f), e=e, o=o, a=a, b=b)
    run_asm("fe_row_odd", env)
    run_asm("fe_row_even", env)
    _redc_row(f, e, o)


def fe_mul(f, a, b):
    e, o = [0] * 8, [0] * 8
    for j in range(0, 8, 2):
        pe, po = a[j] * b[0], a[j + 1] * b[0]
        e[j], e[j + 1], o[j], o[j + 1] = pe & MASK, pe >> 32, po & MASK, po >> 32
    _redc_row(f, e, o)
    for i in range(1, 8, 2):
        _row(f, o, e, a, b[i])
        if i + 1 < 8:
            _row(f, e, o, a, b[i + 1])
    env = dict(e=e, o=o, r=[None] * 8)
    run_asm("fe_merge", env)
    return env["r"]


def fe_mul_sum(f, a, b, c, d):
    """fe_mul_sum's rows: a*b_i by fe_row_odd / fe_row_even, c*d_i by
    fe_mad_odd / fe_row_even on the same accumulators, one reduction."""
    e, o = [0] * 8, [0] * 8
    for j in range(0, 8, 2):
        pe, po = a[j] * b[0], a[j + 1] * b[0]
        e[j], e[j + 1], o[j], o[j + 1] = pe & MASK, pe >> 32, po & MASK, po >> 32

    def second(e, o, i):
        run_asm("fe_mad_odd", dict(o=o, a=c, b=d[i]))
        run_asm("fe_row_even", dict(e=e, o=o, a=c, b=d[i]))
        _redc_row(f, e, o)

    second(e, o, 0)
    for i in range(1, 8, 2):
        for ev, od, k in ((o, e, i), (e, o, i + 1)):
            if k < 8:
                env = dict(e=ev, o=od, a=a, b=b[k])
                run_asm("fe_row_odd", env)
                run_asm("fe_row_even", env)
                second(ev, od, k)
    env = dict(e=e, o=o, r=[None] * 8)
    run_asm("fe_merge", env)
    return env["r"]


def fe_sqr(f, a):
    u, v = [0] * 16, [0] * 16
    for i in range(7):  # distance 1 starts u, distance 2 starts v
        p1 = a[i] * a[i + 1]
        u[2 * i + 1], u[2 * i + 2] = p1 & MASK, p1 >> 32
        if i + 2 < 8:
            p2 = a[i] * a[i + 2]
            v[2 * i + 2], v[2 * i + 3] = p2 & MASK, p2 >> 32
    env = dict(_env(f), u=u, v=v, a=list(a))
    for fn in ("fe_sqr_d3", "fe_sqr_d5", "fe_sqr_d7", "fe_sqr_d4", "fe_sqr_d6", "fe_sqr_join"):
        run_asm(fn, env)
    env["t"] = u
    run_asm("fe_sqr_double", env)
    run_asm("fe_sqr_diag", env)
    assert unwords16(u) == unwords(a) ** 2  # the whole 16-word square
    e, o = u[:8], [0] * 8
    _redc_row(f, e, o)
    for i in range(1, 8):
        e, o = o, e  # the roles swap with each division by 2^32
        env = dict(_env(f), e=e, o=o, m=0)
        run_asm("fe_redc_shift_odd", env)
        run_asm("fe_redc_even", env)
        assert e[0] == 0
    e, o = o, e  # back to the names fe_merge has after the last row
    env = dict(e=e, o=o, r=[None] * 8)
    run_asm("fe_merge", env)
    return fe_add8(f, env["r"], u[8:])


def unwords16(w):
    return sum(x << (32 * i) for i, x in enumerate(w))


def lazy_mont(f, a, b):
    """(a·b + M·p) / R for the unique M < R that clears the low 256 bits."""
    p = SPECS[f].p
    M = (-a * b * pow(p, -1, R)) % R
    t = a * b + M * p
    assert t % R == 0
    return t // R


def lazy_mont_sum(f, a, b, c, d):
    """(a·b + c·d + M·p) / R for the unique M < R that clears the low 256
    bits."""
    p = SPECS[f].p
    t = a * b + c * d
    M = (-t * pow(p, -1, R)) % R
    assert (t + M * p) % R == 0
    return (t + M * p) // R


def edge_values(f):
    p = SPECS[f].p
    return [0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p, (1 << 254) - 1, MASK, MASK << 224]


def lazy(f):
    return st.integers(0, 2 * SPECS[f].p)


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("f", ["fq", "fr"])
def test_source_constants_match_the_spec(f):
    p = SPECS[f].p
    assert unwords(P_WORDS[f]) == p and unwords(P2_WORDS[f]) == 2 * p
    assert PINV[f] == (-pow(p, -1, 1 << 32)) % (1 << 32)


@pytest.mark.parametrize("f", ["fq", "fr"])
def test_mul_schedule_on_edge_values(f):
    vals = [v for v in edge_values(f) if v <= 2 * SPECS[f].p]
    for a in vals:
        for b in vals:
            got = unwords(fe_mul(f, words(a), words(b)))
            assert got == lazy_mont(f, a, b) and got <= 2 * SPECS[f].p, (a, b)


@pytest.mark.parametrize("f", ["fq", "fr"])
def test_mul_schedule_on_drawn_values(f):
    @settings(max_examples=60, deadline=None, database=None, derandomize=True)
    @given(lazy(f), lazy(f))
    def run(a, b):
        assert unwords(fe_mul(f, words(a), words(b))) == lazy_mont(f, a, b)

    run()


@pytest.mark.parametrize("f", ["fq", "fr"])
def test_mul_sum_schedule_on_edge_and_drawn_values(f):
    """fe_mul_sum against python ints over [0, 2p]: the extremes (a = b = c
    = d = 2p among them, the largest running sum) and hypothesis draws.
    The result lies below 2.52p, outside [0, 2p], and fe_canon maps it to
    the canonical product sum; no statement drops a carry."""
    p = SPECS[f].p
    edges = [0, 1, p - 1, p, 2 * p - 1, 2 * p]
    for a, b, c, d in [(2 * p,) * 4, (2 * p, 2 * p, 0, 0), (0, 0, 2 * p, 2 * p),
                       (2 * p, 1, 2 * p, 2 * p - 1), (p, p, p, p)] + [
            (x, y, y, x) for x in edges for y in edges]:
        got = unwords(fe_mul_sum(f, words(a), words(b), words(c), words(d)))
        assert got == lazy_mont_sum(f, a, b, c, d) and got < 2.52 * p, (a, b, c, d)
        canon = unwords(fe_canon(f, words(got)))
        assert canon == (a * b + c * d) * pow(R, -1, p) % p

    @settings(max_examples=60, deadline=None, database=None, derandomize=True)
    @given(lazy(f), lazy(f), lazy(f), lazy(f))
    def run(a, b, c, d):
        got = fe_mul_sum(f, words(a), words(b), words(c), words(d))
        assert unwords(got) == lazy_mont_sum(f, a, b, c, d)

    run()


@pytest.mark.parametrize("f", ["fq", "fr"])
def test_sqr_schedule_on_edge_and_drawn_values(f):
    for a in [v for v in edge_values(f) if v <= 2 * SPECS[f].p]:
        got = fe_sqr(f, words(a))
        assert unwords(got) == lazy_mont(f, a, a) and got == fe_mul(f, words(a), words(a)), a

    @settings(max_examples=60, deadline=None, database=None, derandomize=True)
    @given(lazy(f))
    def run(a):
        assert unwords(fe_sqr(f, words(a))) == lazy_mont(f, a, a)

    run()


@pytest.mark.parametrize("f", ["fq", "fr"])
def test_sqr_schedule_builds_the_square_of_any_256_bit_value(f):
    """The product half has no modulus in it: it must hold for inputs beyond
    the lazy range too (the asserts inside fe_sqr check the 16 words)."""
    rng = np.random.default_rng(33)
    for a in [R - 1, R - (1 << 224), MASK << 224 | MASK] + [
            int.from_bytes(rng.bytes(32), "little") for _ in range(8)]:
        u, v = [0] * 16, [0] * 16
        w = words(a)
        for i in range(7):
            p1 = w[i] * w[i + 1]
            u[2 * i + 1], u[2 * i + 2] = p1 & MASK, p1 >> 32
            if i + 2 < 8:
                p2 = w[i] * w[i + 2]
                v[2 * i + 2], v[2 * i + 3] = p2 & MASK, p2 >> 32
        env = dict(_env(f), u=u, v=v, a=w, t=u)
        for fn in ("fe_sqr_d3", "fe_sqr_d5", "fe_sqr_d7", "fe_sqr_d4", "fe_sqr_d6", "fe_sqr_join",
                   "fe_sqr_double", "fe_sqr_diag"):
            run_asm(fn, env)
        assert unwords16(u) == a * a


@pytest.mark.parametrize("f", ["fq", "fr"])
def test_mul_schedule_equals_the_plain_version_bit_for_bit(f):
    rng = np.random.default_rng(31)
    p = SPECS[f].p
    vals = [0, p, 2 * p] + [int.from_bytes(rng.bytes(32), "little") % (2 * p + 1)
                            for _ in range(13)]
    a = torch.from_numpy(np.stack([int_to_limbs(v) for v in vals]).astype(np.int64))
    b = a.flip(0)
    want = PLAIN[f].mul(a, b).numpy()
    for i, (x, y) in enumerate(zip(vals, vals[::-1])):
        assert unwords(fe_mul(f, words(x), words(y))) == limbs_to_int(want[i]), i


def test_sqr_chain_wrapper_equals_the_schedule_step_by_step():
    """`cuda_ops.fq_sqr_chain` on the CPU (the plain version of the squaring
    chain kernel) against ch steps of the fe_sqr schedule, lazy words."""
    from snark_verifier_tpu_torch.ff import limbs_to_words, words_to_limbs
    from snark_verifier_tpu_torch.msm import cuda_ops

    rng = np.random.default_rng(34)
    p = FQ.p
    vals = [0, p, 2 * p] + [int.from_bytes(rng.bytes(32), "little") % (2 * p + 1) for _ in range(5)]
    a = limbs_to_words(torch.from_numpy(np.stack([int_to_limbs(v) for v in vals]).astype(np.int64)))
    got = words_to_limbs(cuda_ops.fq_sqr_chain(a, 3)).numpy()
    for i, v in enumerate(vals):
        w = words(v)
        for _ in range(3):
            w = fe_sqr("fq", w)
        assert unwords(w) == limbs_to_int(got[i]), i
    with pytest.raises(ValueError):
        cuda_ops.fq_sqr_chain(a, -1)


@pytest.mark.parametrize("f", ["fq", "fr"])
def test_mul_schedule_is_symmetric_and_keeps_montgomery_form(f):
    p = SPECS[f].p
    rng = np.random.default_rng(32)
    for _ in range(8):
        x, y = (int.from_bytes(rng.bytes(32), "little") % p for _ in range(2))
        xm, ym = x * R % p, y * R % p
        got = fe_mul(f, words(xm), words(ym))
        assert got == fe_mul(f, words(ym), words(xm))
        assert unwords(fe_canon(f, got)) == x * y * R % p


@pytest.mark.parametrize("f", ["fq", "fr"])
def test_add_sub_neg_canon_chains(f):
    p = SPECS[f].p
    F = PLAIN[f]

    def limbs(v):
        return torch.from_numpy(int_to_limbs(v).astype(np.int64))

    vals = [v for v in edge_values(f) if v <= 2 * p]
    for a in vals:
        assert unwords(fe_neg(f, words(a))) == 2 * p - a
        assert unwords(fe_canon(f, words(a))) == a % p
        for b in vals:
            s = a + b
            assert unwords(fe_add(f, words(a), words(b))) == (s - 2 * p if s >= 2 * p else s)
            d = a - b
            assert unwords(fe_sub(f, words(a), words(b))) == (d + 2 * p if d < 0 else d)
            assert unwords(fe_add(f, words(a), words(b))) == limbs_to_int(
                F.add(limbs(a), limbs(b)).numpy())
            assert unwords(fe_sub(f, words(a), words(b))) == limbs_to_int(
                F.sub(limbs(a), limbs(b)).numpy())


@pytest.mark.parametrize("f", ["fq", "fr"])
def test_add_sub_on_drawn_values(f):
    p = SPECS[f].p

    @settings(max_examples=100, deadline=None, database=None, derandomize=True)
    @given(lazy(f), lazy(f))
    def run(a, b):
        s, d = a + b, a - b
        assert unwords(fe_add(f, words(a), words(b))) == (s - 2 * p if s >= 2 * p else s)
        assert unwords(fe_sub(f, words(a), words(b))) == (d + 2 * p if d < 0 else d)

    run()


def test_interpreter_reports_a_dropped_carry_and_an_unset_flag():
    """The interpreter's own checks, on hand-made statements."""
    global SRC
    saved = SRC
    try:
        SRC = ('void bad_drop(x) {\n asm("add.u32 %0, %1, %2;" : "=r"(r[0]) : "r"(a[0]), '
               '"r"(b[0]));\n}\n'
               'void bad_flag(x) {\n asm("addc.u32 %0, %1, %2;" : "=r"(r[0]) : "r"(a[0]), '
               '"r"(b[0]));\n}\n')
        with pytest.raises(DroppedCarry):
            run_asm("bad_drop", dict(r=[None], a=[MASK], b=[1]))
        with pytest.raises(AssertionError, match="before any"):
            run_asm("bad_flag", dict(r=[None], a=[1], b=[1]))
    finally:
        SRC = saved
