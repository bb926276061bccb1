"""A minimal Yul interpreter that executes the generated verifier contracts
in-process: the port's copy of the JAX package's `loader/yul_interp.py`, the
stand-in for the reference's revm executor (snark-verifier
src/loader/evm/util/executor.rs, which snark-verifier-sdk src/evm.rs:178-192
`evm_verify` runs).  It interprets the Yul source directly, with the BN254
precompiles (0x05 modexp, 0x06 ecAdd, 0x07 ecMul, 0x08 pairing) on the
port's python-int oracles (`ec/py_ec.py`, `pairing/py_pairing.py`) and the
host Keccak-256 (`hash/keccak.py`).  Host code: it makes no torch call.

Supported subset: what `loader/evm_loader.py` emits plus the contract
template (objects, functions, blocks, let/assignment, if, and the EVM
builtins below).  The word type is uint256 (wrap-around).

Gas: intrinsic 21000 + calldata (16/4 a non-zero/zero byte, EIP-2028) +
per-builtin costs + Istanbul precompile costs (EIP-1108: ecAdd 150, ecMul
6000, pairing 45000 + 34000·k) + keccak (30 + 6 a word) + memory expansion
(3·w + w²/512).  Stack operations are approximated at the builtin level
(PUSH/DUP/SWAP not modelled), so totals run a few percent below a real EVM
trace.  The count equals the JAX interpreter's unit for unit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

WORD = (1 << 256) - 1


class YulError(ValueError):
    """Source outside the supported Yul subset, or a malformed program."""


class PrecompileError(Exception):
    """A precompile refused its input: the staticcall returns 0."""


# ------------------------------------------------------------------- lexer


def tokenize(src: str) -> List[str]:
    toks = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
        elif src.startswith("//", i):
            i = src.find("\n", i)
            i = n if i < 0 else i
        elif src.startswith(":=", i):
            toks.append(":=")
            i += 2
        elif src.startswith("->", i):
            toks.append("->")
            i += 2
        elif c in "{}(),":
            toks.append(c)
            i += 1
        elif c == '"':
            j = src.find('"', i + 1)
            toks.append(src[i : j + 1])
            i = j + 1
        else:
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_$.:"):
                j += 1
            if j == i:
                raise YulError(f"lex error at {src[i:i+20]!r}")
            toks.append(src[i:j])
            i = j
    return toks


# ------------------------------------------------------------------ parser
#
# AST: ("block", [stmts]) | ("fun", name, params, rets, body)
#    | ("let", [names], expr|None) | ("assign", [names], expr)
#    | ("if", cond, block) | ("expr", expr)
# expr: ("num", v) | ("var", name) | ("call", name, [exprs])


class Parser:
    def __init__(self, toks: List[str]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise YulError("unexpected end of source")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, t: str):
        got = self.next()
        if got != t:
            raise YulError(f"expected {t!r}, got {got!r}")

    def parse_objects(self) -> Dict[str, tuple]:
        """-> {object_name: code_block}; nested objects flattened."""
        out: Dict[str, tuple] = {}
        while self.peek() is not None:
            out.update(self.parse_single_object())
        return out

    def parse_single_object(self) -> Dict[str, tuple]:
        out: Dict[str, tuple] = {}
        self.expect("object")
        name = self.next().strip('"')
        self.expect("{")
        while self.peek() != "}":
            t = self.peek()
            if t == "code":
                self.next()
                out[name] = self.parse_block()
            elif t == "object":
                out.update(self.parse_single_object())
            else:
                raise YulError(f"unexpected {t!r} in object")
        self.expect("}")
        return out

    def parse_block(self) -> tuple:
        self.expect("{")
        stmts = []
        while self.peek() != "}":
            stmts.append(self.parse_stmt())
        self.expect("}")
        return ("block", stmts)

    def parse_stmt(self) -> tuple:
        t = self.peek()
        if t == "{":
            return self.parse_block()
        if t == "function":
            self.next()
            name = self._strip_type(self.next())
            self.expect("(")
            params = []
            while self.peek() != ")":
                params.append(self._strip_type(self.next()))
                if self.peek() == ",":
                    self.next()
            self.expect(")")
            rets = []
            if self.peek() == "->":
                self.next()
                while self.peek() != "{":
                    rets.append(self._strip_type(self.next()))
                    if self.peek() == ",":
                        self.next()
            body = self.parse_block()
            return ("fun", name, params, rets, body)
        if t == "let":
            self.next()
            names = [self._strip_type(self.next())]
            while self.peek() == ",":
                self.next()
                names.append(self._strip_type(self.next()))
            expr = None
            if self.peek() == ":=":
                self.next()
                expr = self.parse_expr()
            return ("let", names, expr)
        if t == "if":
            self.next()
            cond = self.parse_expr()
            return ("if", cond, self.parse_block())
        # assignment or expression statement
        save = self.i
        name = self.next()
        if self.peek() == ":=":
            self.next()
            return ("assign", [self._strip_type(name)], self.parse_expr())
        self.i = save
        return ("expr", self.parse_expr())

    @staticmethod
    def _strip_type(name: str) -> str:
        return name.split(":")[0]

    def parse_expr(self) -> tuple:
        t = self.next()
        if t[0].isdigit():
            return ("num", int(t, 16) if t.startswith("0x") else int(t))
        if t.startswith('"'):
            return ("str", t.strip('"'))
        if self.peek() == "(":
            self.next()
            args = []
            while self.peek() != ")":
                args.append(self.parse_expr())
                if self.peek() == ",":
                    self.next()
            self.expect(")")
            return ("call", self._strip_type(t), args)
        if t == "true":
            return ("num", 1)
        if t == "false":
            return ("num", 0)
        return ("var", self._strip_type(t))


# ------------------------------------------------------------- interpreter


class Halt(Exception):
    def __init__(self, success: bool, data: bytes = b""):
        self.success = success
        self.data = data


_GAS3 = {"add", "sub", "mul", "and", "or", "xor", "not", "lt", "gt", "eq",
         "iszero", "shl", "shr", "calldataload", "mload", "mstore", "mstore8",
         "pop"}


class YulVM:
    """Executes one code block with EVM memory/calldata semantics."""

    def __init__(self, calldata: bytes):
        self.calldata = calldata
        self.memory = bytearray()
        self.gas_used = 21000 + sum(
            16 if b else 4 for b in calldata
        )  # intrinsic + EIP-2028 calldata
        self.funs: Dict[str, tuple] = {}
        self._mem_words = 0

    # memory helpers -----------------------------------------------------

    def _expand(self, end: int):
        if end > len(self.memory):
            self.memory.extend(b"\x00" * (end - len(self.memory)))
        words = (end + 31) // 32
        if words > self._mem_words:
            # EVM memory expansion gas: 3·w + floor(w²/512), charged on delta
            cost_new = 3 * words + words * words // 512
            cost_old = 3 * self._mem_words + self._mem_words ** 2 // 512
            self.gas_used += cost_new - cost_old
            self._mem_words = words

    def mload(self, p: int) -> int:
        self._expand(p + 32)
        return int.from_bytes(self.memory[p : p + 32], "big")

    def mstore(self, p: int, v: int):
        self._expand(p + 32)
        self.memory[p : p + 32] = (v & WORD).to_bytes(32, "big")

    # execution ----------------------------------------------------------

    def run(self, block: tuple):
        # hoist function definitions (Yul functions are block-scoped; the
        # generated code only defines them at the top level)
        self._hoist(block)
        try:
            self.exec_block(block, {})
        except Halt as h:
            if not h.success:
                raise
            return h.data
        return b""

    def _hoist(self, block: tuple):
        for st in block[1]:
            if st[0] == "fun":
                self.funs[st[1]] = st
            elif st[0] == "block":
                self._hoist(st)

    def exec_block(self, block: tuple, scope: Dict[str, int]):
        for st in block[1]:
            self.exec_stmt(st, scope)

    def exec_stmt(self, st: tuple, scope: Dict[str, int]):
        op = st[0]
        if op == "block":
            self.exec_block(st, scope)
        elif op == "fun":
            pass  # hoisted
        elif op == "let":
            vals = self.eval_multi(st[2], len(st[1]), scope) if st[2] else [0] * len(st[1])
            for n, v in zip(st[1], vals):
                scope[n] = v
        elif op == "assign":
            vals = self.eval_multi(st[2], len(st[1]), scope)
            for n, v in zip(st[1], vals):
                if n not in scope:
                    raise YulError(f"assign to undeclared {n}")
                scope[n] = v
        elif op == "if":
            if self.eval(st[1], scope):
                self.exec_block(st[2], dict(scope))
        elif op == "expr":
            self.eval_multi(st[1], 0, scope)
        else:
            raise YulError(f"stmt {op}")

    def eval_multi(self, e: tuple, nret: int, scope) -> List[int]:
        v = self.eval(e, scope)
        if isinstance(v, list):
            return v
        return [v] if v is not None else []

    def eval(self, e: tuple, scope: Dict[str, int]):
        kind = e[0]
        if kind == "num":
            return e[1]
        if kind == "var":
            return scope[e[1]]
        if kind != "call":
            raise YulError(f"expression {kind}")
        name, argexprs = e[1], e[2]
        if name in self.funs:
            args = [self.eval(a, scope) for a in argexprs]
            return self.call_fun(self.funs[name], args)
        return self.builtin(name, argexprs, scope)

    def call_fun(self, fun: tuple, args: List[int]):
        _, name, params, rets, body = fun
        scope = dict(zip(params, args))
        for r_ in rets:
            scope[r_] = 0
        self.gas_used += 25  # call/jump overhead approximation
        self.exec_block(body, scope)
        if not rets:
            return None
        if len(rets) == 1:
            return scope[rets[0]]
        return [scope[r_] for r_ in rets]

    # builtins -----------------------------------------------------------

    def builtin(self, name: str, argexprs: List[tuple], scope):
        A = [self.eval(a, scope) for a in argexprs]
        if name in _GAS3:
            self.gas_used += 3
        if name == "add":
            return (A[0] + A[1]) & WORD
        if name == "sub":
            return (A[0] - A[1]) & WORD
        if name == "mul":
            return (A[0] * A[1]) & WORD
        if name == "mod":
            self.gas_used += 5
            return A[0] % A[1] if A[1] else 0
        if name == "addmod":
            self.gas_used += 8
            return (A[0] + A[1]) % A[2] if A[2] else 0
        if name == "mulmod":
            self.gas_used += 8
            return (A[0] * A[1]) % A[2] if A[2] else 0
        if name == "and":
            return A[0] & A[1]
        if name == "or":
            return A[0] | A[1]
        if name == "xor":
            return A[0] ^ A[1]
        if name == "not":
            return A[0] ^ WORD
        if name == "iszero":
            return 1 if A[0] == 0 else 0
        if name == "lt":
            return 1 if A[0] < A[1] else 0
        if name == "gt":
            return 1 if A[0] > A[1] else 0
        if name == "eq":
            return 1 if A[0] == A[1] else 0
        if name == "shl":
            return (A[1] << A[0]) & WORD if A[0] < 256 else 0
        if name == "shr":
            return A[1] >> A[0] if A[0] < 256 else 0
        if name == "calldataload":
            p = A[0]
            chunk = self.calldata[p : p + 32]
            return int.from_bytes(chunk.ljust(32, b"\x00"), "big")
        if name == "calldatasize":
            return len(self.calldata)
        if name == "mload":
            return self.mload(A[0])
        if name == "mstore":
            self.mstore(A[0], A[1])
            return None
        if name == "mstore8":
            self._expand(A[0] + 1)
            self.memory[A[0]] = A[1] & 0xFF
            return None
        if name == "keccak256":
            from ..hash.keccak import keccak256

            p, ln = A
            self._expand(p + ln)
            self.gas_used += 30 + 6 * ((ln + 31) // 32)
            return int.from_bytes(keccak256(bytes(self.memory[p : p + ln])), "big")
        if name == "gas":
            return 10**9
        if name == "staticcall":
            return self.staticcall(A)
        if name == "revert":
            self._expand(A[0] + A[1])
            raise Halt(False, bytes(self.memory[A[0] : A[0] + A[1]]))
        if name == "return":
            self._expand(A[0] + A[1])
            raise Halt(True, bytes(self.memory[A[0] : A[0] + A[1]]))
        if name == "pop":
            return None
        raise YulError(f"unknown builtin {name}")

    # precompiles --------------------------------------------------------

    def staticcall(self, A: List[int]) -> int:
        _gas, addr, cd, cd_len, rd, rd_len = A
        self.gas_used += 100  # warm account access
        self._expand(cd + cd_len)
        data = bytes(self.memory[cd : cd + cd_len])
        try:
            out, gas = self._precompile(addr, data)
        except PrecompileError:
            return 0
        self.gas_used += gas
        self._expand(rd + rd_len)
        self.memory[rd : rd + rd_len] = out[:rd_len].ljust(rd_len, b"\x00")
        return 1

    def _precompile(self, addr: int, data: bytes) -> Tuple[bytes, int]:
        from ..ec import py_ec
        from ..ff.spec import FQ

        def word(i: int) -> int:
            return int.from_bytes(data[32 * i : 32 * i + 32], "big")

        def pt(i: int):
            x, y = word(i), word(i + 1)
            if x == 0 and y == 0:
                return None
            if not (x < FQ.p and y < FQ.p and py_ec.is_on_curve((x, y))):
                raise PrecompileError(f"G1 point ({x:#x}, {y:#x}) is not on the curve")
            return (x, y)

        def enc(p) -> bytes:
            if p is None:
                return b"\x00" * 64
            return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")

        if addr == 0x05:  # modexp (EIP-198/2565)
            bl, el, ml = word(0), word(1), word(2)
            rest = data[96:]
            B = int.from_bytes(rest[:bl], "big")
            E = int.from_bytes(rest[bl : bl + el], "big")
            M = int.from_bytes(rest[bl + el : bl + el + ml], "big")
            out = pow(B, E, M) if M else 0
            return out.to_bytes(ml, "big"), 200
        if addr == 0x06:  # ecAdd
            return enc(py_ec.add(pt(0), pt(2))), 150
        if addr == 0x07:  # ecMul
            return enc(py_ec.scalar_mul(pt(0), word(2))), 6000
        if addr == 0x08:  # pairing
            from ..pairing import py_pairing as pp

            if len(data) % 192:
                raise PrecompileError(f"pairing input of {len(data)} bytes")
            k = len(data) // 192
            pairs = []
            for i in range(k):
                g1 = pt(6 * i)
                x_im, x_re = word(6 * i + 2), word(6 * i + 3)
                y_im, y_re = word(6 * i + 4), word(6 * i + 5)
                g2 = ((x_re, x_im), (y_re, y_im))
                if g1 is None:
                    continue  # e(O, Q) = 1
                if g2 == ((0, 0), (0, 0)):
                    continue  # e(P, O) = 1
                if not pp.g2_is_on_curve(g2):
                    raise PrecompileError("G2 point is not on the twist")
                pairs.append((g1, g2))
            ok = pp.pairing_check(pairs) if pairs else True
            return (1 if ok else 0).to_bytes(32, "big"), 45000 + 34000 * k
        raise PrecompileError(f"precompile {addr:#x}")


def execute_yul(source: str, calldata: bytes) -> Tuple[bool, int, bytes]:
    """Run the Runtime object of a generated verifier.

    Returns (success, gas_used, return_or_revert_data)."""
    objs = Parser(tokenize(source)).parse_objects()
    if "Runtime" not in objs:
        raise YulError(f"no Runtime object in {list(objs)}")
    vm = YulVM(calldata)
    try:
        data = vm.run(objs["Runtime"])
        return True, vm.gas_used, data
    except Halt as h:
        return False, vm.gas_used, h.data
