"""An execution-trace debugger for generated EVM verifiers: the port's copy
of the JAX package's `loader/evm_debug.py`, the counterpart of the
reference's foundry debugger TUI (snark-verifier src/loader/evm/test/tui.rs,
fed by the revm executor's DebugStep trace).  A tracing VM over the port's
Yul interpreter records every executed statement with its gas, a
per-function gas and call report, and a small stepper (`DebugTrace.tui`)
with the reference's navigation verbs (step, jump, search, quit), stream to
stream so that it is scriptable and testable without a terminal.

Usage:
    trace = debug_yul(yul_source, calldata)
    print(trace.gas_report())          # per-function gas, sorted
    print(trace.render(0, 40))         # first 40 steps
    trace.tui()                        # interactive stepper on stdin/stdout
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .yul_interp import Halt, Parser, YulVM, tokenize


def unparse(e: tuple) -> str:
    """AST tuple -> Yul source text (statements and expressions)."""
    k = e[0]
    if k == "num":
        v = e[1]
        return hex(v) if v >= 1 << 16 else str(v)
    if k == "var":
        return e[1]
    if k == "call":
        return f"{e[1]}({', '.join(unparse(a) for a in e[2])})"
    if k == "let":
        rhs = f" := {unparse(e[2])}" if e[2] else ""
        return f"let {', '.join(e[1])}{rhs}"
    if k == "assign":
        return f"{', '.join(e[1])} := {unparse(e[2])}"
    if k == "if":
        return f"if {unparse(e[1])} {{ ... }}"
    if k == "expr":
        return unparse(e[1])
    if k == "block":
        return "{ ... }"
    if k == "fun":
        return f"function {e[1]}({', '.join(e[2])}) -> {', '.join(e[3])}"
    return repr(e)


@dataclass
class DebugStep:
    """One executed leaf statement (the analogue of revm's DebugStep:
    pc/opcode become function-frame/statement-text, stack becomes the
    statement's written variables)."""

    index: int
    depth: int
    function: str
    text: str
    gas_before: int
    gas_cost: int  # inclusive: nested calls made by this statement
    writes: Dict[str, int] = field(default_factory=dict)

    def format(self, width: int = 100) -> str:
        ind = "  " * min(self.depth, 8)
        txt = (ind + self.text)[: width - 34]
        w = ""
        if self.writes:
            n, v = next(iter(self.writes.items()))
            w = f" | {n}={hex(v)[:18]}"
        return f"{self.index:>6} {self.gas_before:>9} {self.gas_cost:>7}  {txt}{w}"


@dataclass
class FunStats:
    calls: int = 0
    total_gas: int = 0  # inclusive
    self_gas: int = 0  # exclusive of callees


class TracingVM(YulVM):
    """YulVM that records leaf-statement steps and per-function gas."""

    def __init__(self, calldata: bytes, max_steps: int = 500_000):
        super().__init__(calldata)
        self.steps: List[DebugStep] = []
        self.max_steps = max_steps
        self.fun_stats: Dict[str, FunStats] = {}
        self.precompile_calls: List[Tuple[int, int]] = []  # (addr, gas)
        self._frames: List[str] = ["<main>"]
        self._child_gas: List[int] = [0]
        self._depth = 0

    def exec_stmt(self, st, scope):
        op = st[0]
        if op in ("block", "fun"):
            return super().exec_stmt(st, scope)
        g0 = self.gas_used
        record = len(self.steps) < self.max_steps
        before = dict(scope) if record and op in ("let", "assign") else None
        super().exec_stmt(st, scope)
        if record:
            writes = {}
            if op in ("let", "assign"):
                for n in st[1]:
                    if n in scope and (before is None or scope.get(n) != before.get(n)
                                       or n not in before):
                        writes[n] = scope[n]
            self.steps.append(DebugStep(
                index=len(self.steps), depth=self._depth,
                function=self._frames[-1], text=unparse(st),
                gas_before=g0, gas_cost=self.gas_used - g0, writes=writes,
            ))

    def call_fun(self, fun, args):
        name = fun[1]
        g0 = self.gas_used
        self._frames.append(name)
        self._child_gas.append(0)
        self._depth += 1
        try:
            return super().call_fun(fun, args)
        finally:
            self._depth -= 1
            child = self._child_gas.pop()
            self._frames.pop()
            total = self.gas_used - g0
            st = self.fun_stats.setdefault(name, FunStats())
            st.calls += 1
            st.total_gas += total
            st.self_gas += total - child
            self._child_gas[-1] += total

    def staticcall(self, A):
        g0 = self.gas_used
        out = super().staticcall(A)
        self.precompile_calls.append((A[1], self.gas_used - g0))
        return out


@dataclass
class DebugTrace:
    """Collected run: the debug_arena analogue handed to the reference TUI."""

    success: bool
    gas_used: int
    returndata: bytes
    steps: List[DebugStep]
    fun_stats: Dict[str, FunStats]
    precompile_calls: List[Tuple[int, int]]
    truncated: bool

    # ------------------------------------------------------------ reports

    def gas_report(self, top: int = 20) -> str:
        """Per-function gas attribution (self gas, sorted descending) —
        what the reference uses its debugger for when a verifier blows the
        block gas limit."""
        rows = sorted(self.fun_stats.items(), key=lambda kv: -kv[1].self_gas)
        lines = [f"{'function':<40} {'calls':>6} {'self gas':>10} {'total':>10}"]
        for name, st in rows[:top]:
            lines.append(f"{name:<40} {st.calls:>6} {st.self_gas:>10} {st.total_gas:>10}")
        pre = {}
        for addr, g in self.precompile_calls:
            c, t = pre.get(addr, (0, 0))
            pre[addr] = (c + 1, t + g)
        names = {5: "modexp", 6: "ecAdd", 7: "ecMul", 8: "ecPairing"}
        for addr, (c, t) in sorted(pre.items()):
            lines.append(f"{'precompile 0x%02x (%s)' % (addr, names.get(addr, '?')):<40}"
                         f" {c:>6} {t:>10} {t:>10}")
        lines.append(f"{'TOTAL':<40} {'':>6} {'':>10} {self.gas_used:>10}")
        return "\n".join(lines)

    def render(self, start: int = 0, count: int = 30) -> str:
        """Step listing: index, cumulative gas, per-statement gas, text."""
        hdr = f"{'step':>6} {'gas':>9} {'cost':>7}  statement"
        body = [s.format() for s in self.steps[start : start + count]]
        tail = []
        if self.truncated:
            tail.append(f"... trace truncated at {len(self.steps)} steps")
        return "\n".join([hdr] + body + tail)

    def find(self, pattern: str, after: int = 0) -> Optional[int]:
        rx = re.compile(pattern)
        for s in self.steps[after:]:
            if rx.search(s.text) or rx.search(s.function):
                return s.index
        return None

    # -------------------------------------------------------------- tui

    def tui(self, inp=None, out=None, page: int = 24):
        """Interactive stepper (reference tui.rs navigation verbs, stream
        form): n/<enter> page forward, p back, j N jump, /pat search,
        g gas report, q quit."""
        inp = inp if inp is not None else sys.stdin
        out = out if out is not None else sys.stdout
        pos = 0

        def show():
            out.write(self.render(pos, page) + "\n")

        out.write(f"yul debugger: {len(self.steps)} steps, gas {self.gas_used}, "
                  f"{'OK' if self.success else 'REVERTED'}\n")
        show()
        for line in inp:
            cmd = line.strip()
            if cmd in ("q", "quit"):
                break
            elif cmd in ("", "n"):
                pos = min(pos + page, max(0, len(self.steps) - 1))
            elif cmd == "p":
                pos = max(0, pos - page)
            elif cmd.startswith("j "):
                try:
                    tgt = int(cmd[2:], 0)
                except ValueError:
                    out.write("usage: j <step-number>\n")
                    continue
                pos = max(0, min(tgt, len(self.steps) - 1))
            elif cmd.startswith("/"):
                try:
                    hit = self.find(cmd[1:], after=pos + 1)
                except re.error as e:
                    out.write(f"bad pattern: {e}\n")
                    continue
                if hit is None:
                    out.write("no match\n")
                    continue
                pos = hit
            elif cmd == "g":
                out.write(self.gas_report() + "\n")
                continue
            else:
                out.write("commands: n p j<N> /pat g q\n")
                continue
            show()


def debug_yul(source: str, calldata: bytes,
              max_steps: int = 500_000) -> DebugTrace:
    """Execute a generated verifier under the tracing VM (the analogue of
    the reference's `Evm::debug` entry, loader/evm/test.rs + executor.rs)."""
    objs = Parser(tokenize(source)).parse_objects()
    code = objs.get("Runtime") or next(iter(objs.values()))
    vm = TracingVM(calldata, max_steps=max_steps)
    try:
        data = vm.run(code)
        success = True
    except Halt as h:
        data, success = h.data, h.success
    return DebugTrace(
        success=success, gas_used=vm.gas_used, returndata=data,
        steps=vm.steps, fun_stats=vm.fun_stats,
        precompile_calls=vm.precompile_calls,
        truncated=len(vm.steps) >= vm.max_steps,
    )
