"""The designs of ``tests/test_synth_opt.py`` and
``tests/test_synth_budgets.py`` (and ``test_fsm_dc.py``'s FSM), free of
JAX, in a form that synthesizes in either package: :func:`synth` builds a
design in package ``pe`` (the JAX package or the port) the way the JAX
test does (one net per port bit; the INPUT devices its test makes, in
port order) and synthesizes it with the test's options;
:func:`schedule` gives the JAX test's stimulus as a ``digital_run``
schedule.  :func:`device_list` and :func:`stats_fields` reduce a result
to what two packages must agree on.
"""

from importlib import import_module
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

L, H, X = 0, 1, 2


class Design(NamedTuple):
    src: str
    top: str
    # "all": an INPUT at X on every input bit (tests_helpers_synth.
    # crosscheck_opt); "clkrst": INPUTs at L on clk and rst_n only;
    # "none": no INPUT
    layout: str
    stim: Callable          # (ins) -> digital_run schedule


def _vectors(vectors):
    """One tick per vector, every input bit set (crosscheck_opt)."""
    def stim(ins):
        return [{m: (v >> i) & 1 for name, v in vec.items()
                 for i, m in enumerate(ins[name])} for vec in vectors]
    return stim


def _counter(cycles):
    """Reset, release, then ``cycles`` clocks (the JAX counter tests)."""
    def stim(ins):
        clk, rst = ins["clk"][0], ins["rst_n"][0]
        sched = [{}, {rst: H}]
        for _ in range(cycles):
            sched += [{clk: H, rst: H}, {clk: L, rst: H}]
        return sched
    return stim


def _xprop(ins):
    return [{ins["b"][0]: H}]            # a stays X


def _fsm(ins, cycles=12, seed=5):
    rng = np.random.default_rng(seed)
    clk, rst = ins["clk"][0], ins["rst_n"][0]
    go, stop = ins["go"][0], ins["stop"][0]
    sched = [{clk: L, rst: L, go: L, stop: L}, {rst: H}]
    for _ in range(cycles):
        g, s = (int(b) for b in rng.integers(0, 2, 2))
        sched += [{clk: H, rst: H, go: g, stop: s},
                  {clk: L, rst: H, go: g, stop: s}]
    return sched


def _rand_vecs(seed, n, **widths):
    rng = np.random.default_rng(seed)
    return [{k: int(rng.integers(1 << w)) for k, w in widths.items()}
            for _ in range(n)]


O1_REDUCE_SRC = """
module m(input [3:0] a, input [3:0] b, output [3:0] y, output z);
  wire [3:0] t1 = a & b;
  wire [3:0] t2 = a & b;        // duplicate -> strash
  wire [3:0] t3 = ~(~t1);       // double inverter
  assign y = t3 | (t2 & 4'b0000);   // const-and -> 0, or -> t2
  assign z = 1'b1 & 1'b1;       // constant folding
endmodule
"""

ALU_SRC = """
module alu(input [3:0] a, input [3:0] b, input [1:0] op,
           output reg [3:0] y);
  always @* begin
    case (op)
      2'd0: y = a + b;
      2'd1: y = a - b;
      2'd2: y = a & b;
      default: y = a ^ b;
    endcase
  end
endmodule
"""

COUNTER_SRC = """
module counter(input clk, input rst_n, output reg [3:0] q);
  always @(posedge clk or negedge rst_n) begin
    if (!rst_n) q <= 4'd0;
    else q <= q + 4'd1;
  end
endmodule
"""

FACTOR_SRC = """
module m(input [3:0] a, input [3:0] b, input [3:0] c, output [3:0] y,
         output [3:0] z, output w);
  assign y = (a & b) | (a & c);                 // -> a & (b|c)
  assign z = (a & ~b) | (~a & b);               // -> a ^ b
  assign w = ~(a[0] & b[0]) | (a[1] & ~c[1]);   // NAND/NIMP selection
endmodule
"""

XPROP_SRC = """
module m(input a, input b, output y);
  assign y = (a & ~b) | (~a & b);
endmodule
"""

SEG7_SRC = """
module seg7(input [3:0] d, output reg [6:0] s);
  always @* begin
    case (d)
      4'h0: s = 7'b0111111; 4'h1: s = 7'b0000110;
      4'h2: s = 7'b1011011; 4'h3: s = 7'b1001111;
      4'h4: s = 7'b1100110; 4'h5: s = 7'b1101101;
      4'h6: s = 7'b1111101; 4'h7: s = 7'b0000111;
      4'h8: s = 7'b1111111; 4'h9: s = 7'b1101111;
      4'hA: s = 7'b1110111; 4'hB: s = 7'b1111100;
      4'hC: s = 7'b0111001; 4'hD: s = 7'b1011110;
      4'hE: s = 7'b1111001; default: s = 7'b1110001;
    endcase
  end
endmodule
"""

COUNTER_WRAP_SRC = """
module counter(input clk, input rst_n, output reg [3:0] q,
               output wrap);
  assign wrap = (q == 4'hF);
  always @(posedge clk or negedge rst_n) begin
    if (!rst_n) q <= 4'd0;
    else q <= q + 4'd1;
  end
endmodule
"""

OMAX_SRC = """
module m(input [3:0] a, input [3:0] b, output [3:0] y, output p);
  assign y = (a & b) | (a & ~b) | (~a & b);   // == a | b
  assign p = ^(a ^ b);
endmodule
"""

ADD8_SRC = """
module full_add(input a, input b, input cin, output s, output cout);
  assign s = a ^ b ^ cin;
  assign cout = (a & b) | (cin & (a ^ b));
endmodule
module add8(input [7:0] a, input [7:0] b, output [7:0] s, output cout);
  wire [8:0] c;
  assign c[0] = 1'b0;
  genvar i;
  generate
    for (i = 0; i < 8; i = i + 1) begin : bits
      full_add fa(.a(a[i]), .b(b[i]), .cin(c[i]), .s(s[i]),
                  .cout(c[i+1]));
    end
  endgenerate
  assign cout = c[8];
endmodule
"""

ESPRESSO_WIDE_SRC = """
module m(input [11:0] a, output y);
  assign y = (a == 12'h003) | (a == 12'h007) |
             (a == 12'h00B) | (a == 12'h00F);
endmodule
"""

PRIORITY_SRC = """
module m(input [11:0] a, output [3:0] enc);
  assign enc = a[11] ? 4'd11 : a[10] ? 4'd10 : a[9] ? 4'd9 :
               a[8] ? 4'd8 : a[7] ? 4'd7 : a[6] ? 4'd6 :
               a[5] ? 4'd5 : a[4] ? 4'd4 : a[3] ? 4'd3 :
               a[2] ? 4'd2 : a[1] ? 4'd1 : 4'd0;
endmodule
"""

MUL2_SRC = """
module m2(input [1:0] a, input [1:0] b, output [3:0] p);
  wire t1 = a[1] & b[0];
  wire t2 = a[0] & b[1];
  wire c1 = t1 & t2;
  wire t3 = a[1] & b[1];
  assign p[0] = a[0] & b[0];
  assign p[1] = t1 ^ t2;
  assign p[2] = t3 ^ c1;
  assign p[3] = t3 & c1;
endmodule
"""

CUT_REWRITE_SRC = """
module m(input [3:0] a, output y);
  // y == a[0] & a[1]  written as a wasteful mux-and-redundancy web
  wire t0 = a[0] ? a[1] : 1'b0;
  wire t1 = a[2] ? t0 : t0;
  wire t2 = (t1 & ~a[3]) | (t1 & a[3]);
  assign y = t2;
endmodule
"""

XZ_DC_SRC = """
module m(input [2:0] d, output reg y);
  always @* begin
    case (d)
      3'd0: y = 1'b1; 3'd1: y = 1'b1;
      3'd2: y = 1'b1; 3'd3: y = 1'b1;
      3'd4: y = 1'b0;
      default: y = 1'bx;         // DC-minable
    endcase
  end
endmodule
"""

RESUB_SRC = """
module m(input [3:0] a, output [2:0] y);
  assign y[0] = (a[0] | a[1]) & (a[2] | a[3]);
  assign y[1] = a[0] | a[1];
  assign y[2] = a[2] | a[3];
endmodule
"""

PASS_REPORT_SRC = """
module m(input [3:0] a, output y);
  assign y = (a[0] & a[1]) | (a[0] & a[2]) | (a[0] & a[3]);
endmodule
"""

BDD_SRC = """
module m(input [3:0] b, input [4:0] f, output y);
  wire g = (b[0] & b[1]) | (b[2] & b[3]);
  // flatten the composition so O0 emits one wide 9-var cone
  assign y = (((b[0] & b[1]) | (b[2] & b[3])) & (f[0] ^ f[1] ^ f[2]))
           | (~((b[0] & b[1]) | (b[2] & b[3])) & ((f[3] & f[4]) | f[0]));
endmodule
"""

MUL8_SRC = """
module mul8x8(input [7:0] a, input [7:0] b, output [15:0] p);
  assign p = a * b;
endmodule
"""

MUL_MIXED_SRC = """
module m(input [4:0] a, input [2:0] b, output [6:0] p);
  assign p = a * b;
endmodule
"""

BLK_SRC = r"""
module blk(input [7:0] a, input [7:0] b, output [7:0] s,
           output any_hi);
  assign s = a + b;
  assign any_hi = |(a & b);
endmodule
"""

FSM_DC_SRC = r"""
module fsm(input clk, input rst_n, input go, input stop,
           output reg [3:0] led);
  reg [3:0] st;
  localparam S_IDLE=4'b0001, S_RUN=4'b0010, S_WAIT=4'b0100,
             S_DONE=4'b1000;
  always @(posedge clk or negedge rst_n) begin
    if (!rst_n) st <= S_IDLE;
    else case (st)
      S_IDLE: if (go) st <= S_RUN;
      S_RUN:  if (stop) st <= S_WAIT; else st <= S_DONE;
      S_WAIT: st <= S_DONE;
      S_DONE: st <= S_IDLE;
      default: st <= S_IDLE;
    endcase
  end
  always @* begin
    case (st)
      S_IDLE: led = 4'h1;
      S_RUN:  led = 4'h3;
      S_WAIT: led = 4'h7;
      S_DONE: led = 4'hf;
      default: led = 4'h0;
    endcase
  end
endmodule
"""

FF_SRC = """
module ff(input clk, input d, output reg q);
  always @(posedge clk) q <= d;
endmodule
"""

MUX_SRC = """
module mux(input s, input a, input b, output reg y);
  always @* y = s ? a : b;
endmodule
"""

_MUL8_VECS = _rand_vecs(7, 32, a=8, b=8) + [
    {"a": 0, "b": 0}, {"a": 255, "b": 255}, {"a": 1, "b": 255}]
_BLK_VECS = [dict(a=a, b=b) for a, b in
             ((0, 0), (1, 1), (0x55, 0xAA), (0xFF, 0x01), (0x3C, 0xC3),
              (17, 42), (255, 255))]

DESIGNS: Dict[str, Design] = {
    "o1_reduce": Design(O1_REDUCE_SRC, "m", "all",
                        _vectors(_rand_vecs(11, 12, a=4, b=4))),
    "alu": Design(ALU_SRC, "alu", "all",
                  _vectors(_rand_vecs(2, 20, a=4, b=4, op=2))),
    "counter": Design(COUNTER_SRC, "counter", "clkrst", _counter(5)),
    "factor": Design(FACTOR_SRC, "m", "all",
                     _vectors(_rand_vecs(17, 20, a=4, b=4, c=4))),
    "xprop": Design(XPROP_SRC, "m", "all", _xprop),
    "seg7": Design(SEG7_SRC, "seg7", "all",
                   _vectors([{"d": i} for i in range(16)])),
    "counter_wrap": Design(COUNTER_WRAP_SRC, "counter", "clkrst",
                           _counter(16)),
    "omax": Design(OMAX_SRC, "m", "all",
                   _vectors(_rand_vecs(23, 24, a=4, b=4))),
    "add8": Design(ADD8_SRC, "add8", "all",
                   _vectors(_rand_vecs(5, 20, a=8, b=8))),
    "espresso_wide": Design(
        ESPRESSO_WIDE_SRC, "m", "all",
        _vectors([{"a": v} for v in (3, 7, 0xB, 0xF, 0, 1, 2, 0x13, 0x803)]
                 + _rand_vecs(4, 16, a=12))),
    "priority": Design(PRIORITY_SRC, "m", "all",
                       _vectors(_rand_vecs(2, 24, a=12)
                                + [{"a": 1 << k} for k in range(12)])),
    "mul2": Design(MUL2_SRC, "m2", "all",
                   _vectors([{"a": a, "b": b} for a in range(4)
                             for b in range(4)])),
    "cut_rewrite": Design(CUT_REWRITE_SRC, "m", "all",
                          _vectors([{"a": i} for i in range(16)])),
    "xz_dc": Design(XZ_DC_SRC, "m", "all",
                    _vectors([{"d": i} for i in range(5)])),
    "resub": Design(RESUB_SRC, "m", "all",
                    _vectors([{"a": i} for i in range(16)])),
    "pass_report": Design(PASS_REPORT_SRC, "m", "all",
                          _vectors([{"a": i} for i in range(16)])),
    "bdd": Design(BDD_SRC, "m", "all",
                  _vectors(_rand_vecs(3, 40, b=4, f=5))),
    "mul8x8": Design(MUL8_SRC, "mul8x8", "all", _vectors(_MUL8_VECS)),
    "mul_mixed": Design(MUL_MIXED_SRC, "m", "all",
                        _vectors(_rand_vecs(11, 24, a=5, b=3))),
    "blk": Design(BLK_SRC, "blk", "all", _vectors(_BLK_VECS)),
    "fsm_dc": Design(FSM_DC_SRC, "fsm", "all", _fsm),
    # test_support_flags_reject_disabled_constructs: no INPUTs, never
    # clocked (synthesis raises)
    "ff": Design(FF_SRC, "ff", "none", None),
    "mux": Design(MUX_SRC, "mux", "none", None),
}

B3 = {"opt_level": 3, "assume_binary_inputs": True}

# (design, SynthOptions keywords; "budgets" as PassBudgets keywords): every
# synthesis that test_synth_opt.py runs, but for its multipliers ...
RUNS_OPT: Tuple[Tuple[str, dict], ...] = (
    ("o1_reduce", {"opt_level": 0}), ("o1_reduce", {"opt_level": 1}),
    ("alu", {"opt_level": 0}), ("alu", {"opt_level": 1}),
    ("counter", {"opt_level": 1}),
    ("factor", {"opt_level": 1}), ("factor", {"opt_level": 2}),
    ("xprop", {"opt_level": 0}), ("xprop", {"opt_level": 2}),
    ("counter_wrap", B3),
    ("omax", {"opt_level": 5, "assume_binary_inputs": True,
              "omax_verify": True, "omax_restarts": 3}),
    ("add8", {"opt_level": 2}),
    ("espresso_wide", {"opt_level": 1}), ("espresso_wide", B3),
    ("priority", B3),
    ("mul2", {"opt_level": 2}),
    ("cut_rewrite", B3), ("xz_dc", B3), ("resub", B3), ("pass_report", B3),
    ("bdd", B3),
    ("mul_mixed", {"opt_level": 2}), ("mul_mixed", B3),
)

# ... which, with test_synth_budgets.py's, are these: the 7-segment
# decoder and the 8 x 8 multiplier of
# test_mul_digit_lowering_o2_bit_exact_and_extracted (O2, O3) and of
# test_opt_levels_monotone_on_mul (O1-O4; the same source, its module
# named "m"), one design here.
MUL8_LEVELS = ({"opt_level": 1}, {"opt_level": 2}, B3,
               {"opt_level": 4, "assume_binary_inputs": True})
RUNS_BUDGETS: Tuple[Tuple[str, dict], ...] = (
    ("seg7", {"opt_level": 1}), ("seg7", B3)) + tuple(
    ("mul8x8", o) for o in MUL8_LEVELS) + (
    ("blk", {**B3, "budgets": dict(sweep_max_pairs=0, resub_max_targets=0,
                                   qm_max_vars=0, decomp_max_vars=0)}),
    ("blk", B3),
    ("blk", {**B3, "budgets": dict(
        qm_max_vars=4, qm_exact_vars=4, qm_max_gates=8, qm_max_targets=2,
        sop_max_vars=4, resub_max_targets=2, resub_max_divisors=2,
        sweep_max_pairs=2, rewrite_max_candidates=1, techmap_max_cut=3,
        decomp_min_vars=4, decomp_max_vars=5)}),
    ("blk", {**B3, "budgets": dict(max_total_models=10 ** 9,
                                   max_total_logic_gates=10 ** 9)}),
    ("fsm_dc", {**B3, "budgets": dict(infer_dc_from_fsm=True)}),
    ("fsm_dc", {**B3, "budgets": dict(infer_dc_from_fsm=False)}),
)


def run_id(design: str, opts: dict) -> str:
    parts = [design, f"O{opts['opt_level']}"]
    parts += sorted(k if v is True else f"{k}={v}" for k, v in opts.items()
                    if k not in ("opt_level", "budgets"))
    parts += [f"{k}={v}" for k, v in sorted(opts.get("budgets", {}).items())]
    return "-".join(parts)


def options(pe, opts: dict):
    """SynthOptions of package ``pe`` from ``opts``."""
    synth = import_module(pe.__name__ + ".verilog.synth")
    optimize = import_module(pe.__name__ + ".verilog.optimize")
    kw = dict(opts)
    if "budgets" in kw:
        kw["budgets"] = optimize.PassBudgets(**kw["budgets"])
    return synth.SynthOptions(**kw)


def synth(pe, make_circuit, design: str, opts: Optional[dict] = None,
          synth_opts=None):
    """``design`` synthesized in package ``pe`` into ``make_circuit()``,
    laid out as its JAX test does.  Returns (circuit, {port: [INPUT per
    bit]}, {port: [net per bit]}, SynthReport)."""
    v = import_module(pe.__name__ + ".verilog")
    synth_mod = import_module(pe.__name__ + ".verilog.synth")
    d = DESIGNS[design]
    dsg = v.build_design(v.compile_source(d.src))
    topm = v.find_module(dsg, d.top)
    inst = v.elaborate(dsg, topm)
    c = make_circuit()
    nl = c.nl
    pn, ins = {}, {}
    for pname in topm.ports:
        sig = inst.signals[pname]
        pn[pname] = [pe.netops.create_node(nl) for _ in range(sig.width)]
        if d.layout == "all" and sig.decl.direction == "input":
            ins[pname] = []
            for n in pn[pname]:
                m = pe.netops.add_model(nl, pe.models.INPUT,
                                        {"boolean": float(X)})
                pe.netops.add_to_node(nl, m, 0, n)
                ins[pname].append(m)
    if d.layout == "clkrst":
        for pname in ("clk", "rst_n"):
            m = pe.netops.add_model(nl, pe.models.INPUT,
                                    {"boolean": float(L)})
            pe.netops.add_to_node(nl, m, 0, pn[pname][0])
            ins[pname] = [m]
    if synth_opts is None:
        synth_opts = options(pe, opts)
    rep = synth_mod.synthesize_to_netlist(nl, dsg, inst, pn, synth_opts)
    return c, ins, pn, rep


def schedule(design: str, ins):
    return DESIGNS[design].stim(ins)


def _param(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


def device_list(nl):
    """Every live device in netlist order as (mdef.name, its pins' nets
    numbered by first use, ground -1 and unconnected -2, params)."""
    num = {id(nl.ground_node): -1}
    out = []
    for m in nl.live_models():
        pins = []
        for p in m.pins:
            if p.node is None:
                pins.append(-2)
                continue
            pins.append(num.setdefault(id(p.node), len(num) - 1))
        out.append((m.mdef.name, tuple(pins),
                    tuple(sorted((k, _param(v)) for k, v in m.params.items()))))
    return out


def stats_fields(stats) -> dict:
    """OptStats field by field, the pass report without its elapsed us
    (None at -O0, which reports none)."""
    if stats is None:
        return None
    d = dict(vars(stats))
    d["passes"] = [tuple(p[:3]) for p in stats.passes]
    return d
