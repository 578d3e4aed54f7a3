"""Cut-based mapping tier: rewrite, resubstitution and DC mining.

Role parity with the reference's structural synthesis passes
(pe_synth.h:159-186 option surface; pass gating at :17595-17625):

* ``cut_rewrite``    — the techmap + aig_rewrite role: enumerate
  4-feasible cuts per node, compute each cut function's truth table,
  re-synthesize it from a memoized recipe library (decomposition /
  exact-QM SOP over both phases / XOR extraction), and accept when the
  MFFC freed exceeds the gates added.  Primitive selection downstream
  (opt_graph._to_gategraph) lowers the rebuilt {AND,OR,NOT,XOR} shapes
  onto the full gate library (NAND/NOR/XNOR/IMP/NIMP) — the AOI/OAI
  template role, since those templates are themselves lowered back to
  primitives in the reference.
* ``resub``          — bounded resubstitution: re-express a node as one
  gate over two existing divisors (signature-filtered, then proven
  exactly over the joint support).
* ``kleene_tt``      — ON/DC planes of a cone whose constants include
  X/Z: with binary inputs the X-driven minterms are don't-cares
  (infer_dc_from_xz role), mined by the QM/espresso tier.
* ``odc_mask``       — local observability don't-cares through
  single-fanout AND/OR/NOT parents (infer_dc_from_odc role, one
  window deep).

All passes operate on the hash-consed ``_Builder`` graph from
opt_graph.py and require the binary-inputs relaxation (they reason in
two-valued truth tables), mirroring the reference's
``assume_binary_inputs`` gating.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

# 4-var leaf patterns (16-bit truth tables), LSB = minterm 0
_PATS4 = (0xAAAA, 0xCCCC, 0xF0F0, 0xFF00)
_MASK = (0x1, 0x3, 0xF, 0xFF, 0xFFFF)      # [k] = mask for k vars

# recipe expression nodes: ("c", 0/1) | ("v", i) | ("n", e) |
# ("a"|"o"|"x", e1, e2)
_RECIPES: Dict[Tuple[int, int], Tuple[float, tuple]] = {}


# ---------------------------------------------------------------------------
# truth tables over a cut frame
# ---------------------------------------------------------------------------

def _pat(k: int, nvars: int) -> int:
    return _PATS4[k] & _MASK[nvars]


def cone_tt(bld, root: int, leaves: Tuple[int, ...]) -> Optional[int]:
    """Truth table of ``root`` over ``leaves`` (<=4); None if the cone
    contains a non-binary constant or escapes the cut."""
    nv = len(leaves)
    mask = _MASK[nv]
    assign = {l: _pat(k, nv) for k, l in enumerate(leaves)}
    memo: Dict[int, Optional[int]] = {}

    def ev(i: int) -> Optional[int]:
        if i in assign:
            return assign[i]
        if i in memo:
            return memo[i]
        n = bld.nodes[i]
        r: Optional[int]
        if n.op == "CONST":
            r = 0 if n.const == 0 else (mask if n.const == 1 else None)
        elif n.op == "PIN":
            r = None                       # escaped the cut
        else:
            f = [ev(x) for x in n.fanins]
            if any(v is None for v in f):
                r = None
            elif n.op == "NOT":
                r = ~f[0] & mask
            elif n.op == "AND":
                r = f[0] & f[1]
            elif n.op == "OR":
                r = f[0] | f[1]
            else:
                r = f[0] ^ f[1]
        memo[i] = r
        return r

    return ev(root)


def _cofactors(tt: int, k: int, nvars: int) -> Tuple[int, int]:
    """(f|var_k=0, f|var_k=1), both filled across the var_k axis."""
    p = _pat(k, nvars)
    sh = 1 << k
    lo = tt & ~p
    hi = tt & p
    return (lo | (lo << sh)) & _MASK[nvars], (hi | (hi >> sh)) & _MASK[nvars]


# ---------------------------------------------------------------------------
# recipe synthesis (memoized minimal-ish implementations of <=4-var TTs)
# ---------------------------------------------------------------------------

_NOT_W = 0.35          # NOTs usually fold into composite primitives


def _recipe_cost(e: tuple) -> float:
    if e[0] in ("c", "v"):
        return 0.0
    if e[0] == "n":
        return _NOT_W + _recipe_cost(e[1])
    return 1.0 + _recipe_cost(e[1]) + _recipe_cost(e[2])


def synth_recipe(tt: int, nvars: int) -> Tuple[float, tuple]:
    """(cost, expr) implementing ``tt`` over vars 0..nvars-1."""
    tt &= _MASK[nvars]
    key = (tt, nvars)
    hit = _RECIPES.get(key)
    if hit is not None:
        return hit
    mask = _MASK[nvars]
    if tt == 0:
        r = (0.0, ("c", 0))
    elif tt == mask:
        r = (0.0, ("c", 1))
    else:
        r = None
        for k in range(nvars):
            if tt == _pat(k, nvars):
                r = (0.0, ("v", k))
                break
            if tt == (~_pat(k, nvars) & mask):
                r = (_NOT_W, ("n", ("v", k)))
                break
    if r is None:
        _RECIPES[key] = (99.0, ("c", 0))   # cycle guard
        best: Optional[Tuple[float, tuple]] = None

        def consider(c, e):
            nonlocal best
            if best is None or c < best[0]:
                best = (c, e)

        # variable decomposition on every var
        for k in range(nvars):
            c0, c1 = _cofactors(tt, k, nvars)
            v = ("v", k)
            if c0 == c1:
                cc, ce = synth_recipe(c0, nvars)
                consider(cc, ce)
                continue
            if c1 == (~c0 & mask):                     # f = var ^ f0
                cc, ce = synth_recipe(c0, nvars)
                consider(cc + 1.0, ("x", v, ce))
            if c0 == 0:                                # f = var & f1
                cc, ce = synth_recipe(c1, nvars)
                consider(cc + 1.0, ("a", v, ce))
            if c1 == 0:                                # f = ~var & f0
                cc, ce = synth_recipe(c0, nvars)
                consider(cc + 1.0 + _NOT_W, ("a", ("n", v), ce))
            if c0 == mask:                             # f = ~var | f1
                cc, ce = synth_recipe(c1, nvars)
                consider(cc + 1.0 + _NOT_W, ("o", ("n", v), ce))
            if c1 == mask:                             # f = var | f0
                cc, ce = synth_recipe(c0, nvars)
                consider(cc + 1.0, ("o", v, ce))
            # general Shannon MUX: (v & f1) | (~v & f0)
            cc0, ce0 = synth_recipe(c0, nvars)
            cc1, ce1 = synth_recipe(c1, nvars)
            consider(cc0 + cc1 + 3.0 + _NOT_W,
                     ("o", ("a", v, ce1), ("a", ("n", v), ce0)))
        # exact-QM SOP on both phases
        from .opt_graph import _qm_primes, _qm_cover
        for phase_tt, inv in ((tt, False), (~tt & mask, True)):
            mt = [m for m in range(1 << nvars)
                  if (phase_tt >> m) & 1]
            if not mt:
                continue
            terms = _qm_cover(mt, _qm_primes(mt, nvars), nvars)
            e = None
            c = 0.0
            for v_, m_ in terms:
                lits = None
                for b in range(nvars):
                    if (m_ >> b) & 1:
                        continue
                    lit = ("v", b) if (v_ >> b) & 1 else ("n", ("v", b))
                    c += 0.0 if lit[0] == "v" else _NOT_W
                    lits = lit if lits is None else ("a", lits, lit)
                    if lits[0] == "a":
                        c += 1.0
                e = lits if e is None else ("o", e, lits)
                if e[0] == "o":
                    c += 1.0
            if e is None:
                continue
            if inv:
                e = ("n", e)
                c += _NOT_W
            consider(c, e)
        r = best
    _RECIPES[key] = r
    return r


def _instantiate(bld, e: tuple, leaves):
    if e[0] == "c":
        return bld.const(e[1])
    if e[0] == "v":
        return leaves[e[1]]
    if e[0] == "n":
        return bld.NOT(_instantiate(bld, e[1], leaves))
    a = _instantiate(bld, e[1], leaves)
    b = _instantiate(bld, e[2], leaves)
    if e[0] == "a":
        return bld.AND(a, b)
    if e[0] == "o":
        return bld.OR(a, b)
    return bld.XOR(a, b)


# ---------------------------------------------------------------------------
# cut enumeration
# ---------------------------------------------------------------------------

def enumerate_cuts(bld, order: List[int], max_cut: int = 4,
                   max_cuts: int = 8) -> Dict[int, List[frozenset]]:
    cuts: Dict[int, List[frozenset]] = {}
    for i in order:
        n = bld.nodes[i]
        if n.op in ("PIN", "CONST"):
            cuts[i] = [frozenset((i,))]
            continue
        if n.op == "NOT":
            merged = list(cuts[n.fanins[0]])
        else:
            a, b = n.fanins
            merged = []
            for ca in cuts[a]:
                for cb in cuts[b]:
                    m = ca | cb
                    if len(m) <= max_cut:
                        merged.append(m)
        merged.sort(key=len)
        uniq: List[frozenset] = []
        seen: Set[frozenset] = set()
        for c in merged:
            if c in seen:
                continue
            seen.add(c)
            if any(o < c for o in uniq):
                continue                       # dominated
            uniq.append(c)
            if len(uniq) >= max_cuts:
                break
        uniq.append(frozenset((i,)))
        cuts[i] = uniq
    return cuts


# ---------------------------------------------------------------------------
# rewrite
# ---------------------------------------------------------------------------

def _op_node(bld, i: int) -> bool:
    return bld.nodes[i].op not in ("PIN", "CONST")


def cut_rewrite(bld, out_map, stats, max_cut: int = 4,
                rounds: int = 2, max_candidates: int = 0):
    """Rewrite cut cones whose recipe implementation frees more gates
    (MFFC) than it adds.  Returns the updated out_map."""
    for _ in range(rounds):
        roots = [idx for (_, idx) in out_map.values()]
        from .opt_graph import _live_order
        order = _live_order(bld, roots)
        ref: Dict[int, int] = {i: 0 for i in order}
        for i in order:
            for f in bld.nodes[i].fanins:
                if f in ref:
                    ref[f] += 1
        for r in roots:
            ref[r] = ref.get(r, 0) + 1
        cuts = enumerate_cuts(bld, order, max_cut)

        repl: Dict[int, int] = {}
        claimed: Set[int] = set()
        global_freed: Set[int] = set()
        changed = 0
        tried = 0
        for i in order:
            n = bld.nodes[i]
            if n.op not in ("AND", "OR", "XOR") or i in claimed:
                continue
            if max_candidates and tried >= max_candidates:
                break
            best_gain = 0.0
            best_new = None
            best_freed: List[int] = []
            best_seen: Set[int] = set()
            for cut in cuts[i]:
                if i in cut or len(cut) < 2:
                    continue
                leaves = tuple(sorted(cut))
                if any(l in claimed for l in leaves):
                    continue
                tt = cone_tt(bld, i, leaves)
                if tt is None:
                    continue
                tried += 1
                # MFFC via trial deref, bounded at the cut leaves
                freed: List[int] = [i]
                dec: List[int] = []

                def deref(j):
                    for f in bld.nodes[j].fanins:
                        if f in cut or not _op_node(bld, f):
                            continue
                        ref[f] -= 1
                        dec.append(f)
                        if ref[f] == 0 and f not in claimed:
                            freed.append(f)
                            deref(f)

                deref(i)
                for f in dec:                   # restore
                    ref[f] += 1
                mffc = sum(1 for j in freed
                           if bld.nodes[j].op != "NOT") + \
                    _NOT_W * sum(1 for j in freed
                                 if bld.nodes[j].op == "NOT")
                cost, recipe = synth_recipe(tt, len(leaves))
                if cost >= mffc:
                    continue
                n0 = len(bld.nodes)
                new = _instantiate(bld, recipe, leaves)
                if new == i:
                    continue
                created = sum(
                    1.0 if bld.nodes[j].op != "NOT" else _NOT_W
                    for j in range(n0, len(bld.nodes)))
                # reused nodes inside the would-be-freed set stay live
                freed_set = set(freed)
                stack = [new]
                seen: Set[int] = set()
                reuse = 0.0
                while stack:
                    j = stack.pop()
                    if j in seen:
                        continue
                    seen.add(j)
                    w = (1.0 if bld.nodes[j].op not in
                         ("NOT", "PIN", "CONST") else
                         (_NOT_W if bld.nodes[j].op == "NOT" else 0.0))
                    if j in freed_set:
                        reuse += w
                        freed_set.discard(j)
                    stack.extend(bld.nodes[j].fanins)
                gain = mffc - reuse - created
                if gain > best_gain + 1e-9:
                    best_gain = gain
                    best_new = new
                    best_freed = sorted(freed_set | {i})
            if best_new is not None:
                repl[i] = best_new
                claimed.add(i)
                claimed.update(best_freed)
                changed += 1
                stats.rewrite_applied += 1
        if not repl:
            break
        out_map = _substitute(bld, out_map, repl)
    return out_map


def _substitute(bld, out_map, repl: Dict[int, int]):
    new_idx: Dict[int, int] = {}

    def sub(i: int) -> int:
        if i in new_idx:
            return new_idx[i]
        j = repl.get(i, i)
        if j != i:
            out = sub(j)
        else:
            n = bld.nodes[i]
            if n.op in ("PIN", "CONST"):
                out = i
            else:
                f = [sub(x) for x in n.fanins]
                out = {"NOT": lambda: bld.NOT(f[0]),
                       "AND": lambda: bld.AND(f[0], f[1]),
                       "OR": lambda: bld.OR(f[0], f[1]),
                       "XOR": lambda: bld.XOR(f[0], f[1])}[n.op]()
        new_idx[i] = out
        return out

    return {k: (net, sub(idx)) for k, (net, idx) in out_map.items()}


# ---------------------------------------------------------------------------
# resubstitution (signature-filtered, exactly proven)
# ---------------------------------------------------------------------------

def resub(bld, out_map, stats, max_divisors: int = 20,
          max_targets: int = 3000):
    """Try to re-express multi-gate cones as ONE gate over two existing
    divisor nodes.  Candidates are filtered by 128-pattern random
    signatures and proven by exhaustive evaluation over the joint
    support (opt_graph._exact_equal machinery)."""
    import numpy as np
    from .opt_graph import (_live_order, _supports, _eval_nodes)

    roots = [idx for (_, idx) in out_map.values()]
    order = _live_order(bld, roots)
    if len(order) > 8000:           # quadratic-ish divisor scan: cap
        max_targets = min(max_targets, 600)
    supp = _supports(bld, order)
    rng = np.random.default_rng(17)
    leaf_words = {i: rng.integers(0, 1 << 63, size=2, dtype=np.uint64)
                  for i in order if bld.nodes[i].op == "PIN"}
    if not leaf_words:
        return out_map
    words = _eval_nodes(bld, order, leaf_words, 2)
    tainted: Set[int] = set()
    for i in order:
        n = bld.nodes[i]
        if (n.op == "CONST" and n.const not in (0, 1)) or \
                any(f in tainted for f in n.fanins):
            tainted.add(i)

    ref: Dict[int, int] = {i: 0 for i in order}
    for i in order:
        for f in bld.nodes[i].fanins:
            ref[f] += 1
    for r in roots:
        ref[r] += 1

    # group nodes by support bitset for divisor lookup
    by_supp: Dict[int, List[int]] = {}
    for i in order:
        if _op_node(bld, i) and i not in tainted:
            by_supp.setdefault(supp[i], []).append(i)

    sig = {i: words[i].tobytes() for i in order}
    repl: Dict[int, int] = {}
    tried = 0
    for i in order:
        n = bld.nodes[i]
        if n.op not in ("AND", "OR", "XOR") or i in repl:
            continue
        if tried >= max_targets:
            break
        s = supp[i]
        # MFFC must exceed 1 gate for a win
        freed = 0
        for f in n.fanins:
            if _op_node(bld, f) and ref[f] == 1:
                freed += 1
        if freed == 0:
            continue
        tried += 1
        # divisors: strictly earlier nodes whose support is a subset
        divs: List[int] = []
        for ds, nodes_ in by_supp.items():
            if ds & ~s:
                continue
            for d in nodes_:
                if d != i and d < i:
                    divs.append(d)
        for l in order:
            if bld.nodes[l].op == "PIN" and (supp[l] & s) and \
                    (supp[l] | s) == s:
                divs.append(l)
        if len(divs) > max_divisors:
            divs = sorted(divs, key=lambda d: -ref.get(d, 0))
            divs = divs[:max_divisors]
        ti = np.frombuffer(sig[i], np.uint64)
        hit = None
        for ai in range(len(divs)):
            if hit:
                break
            for bi in range(ai + 1, len(divs)):
                da, db = divs[ai], divs[bi]
                wa = np.frombuffer(sig[da], np.uint64)
                wb = np.frombuffer(sig[db], np.uint64)
                cands = (("AND", wa & wb), ("OR", wa | wb),
                         ("XOR", wa ^ wb), ("NIMPA", wa & ~wb),
                         ("NIMPB", ~wa & wb), ("NOR", ~(wa | wb)),
                         ("NAND", ~(wa & wb)))
                for kind, wc in cands:
                    if not bool((wc == ti).all()):
                        continue
                    hit = (kind, da, db)
                    break
                if hit:
                    break
        if hit is None:
            continue
        kind, da, db = hit
        build = {"AND": lambda: bld.AND(da, db),
                 "OR": lambda: bld.OR(da, db),
                 "XOR": lambda: bld.XOR(da, db),
                 "NIMPA": lambda: bld.AND(da, bld.NOT(db)),
                 "NIMPB": lambda: bld.AND(bld.NOT(da), db),
                 "NOR": lambda: bld.NOT(bld.OR(da, db)),
                 "NAND": lambda: bld.NOT(bld.AND(da, db))}[kind]
        cand = build()
        if cand == i:
            continue
        from .opt_graph import _exact_equal
        supp2 = dict(supp)
        supp2[cand] = supp.get(cand, supp[da] | supp[db])
        if not _exact_equal(bld, i, cand, supp2, False):
            continue
        repl[i] = cand
        stats.resub_applied += 1
    if not repl:
        return out_map
    return _substitute(bld, out_map, repl)


# ---------------------------------------------------------------------------
# DC-aware SOP rewriting of internal mid-size cones
# ---------------------------------------------------------------------------

def sop_rewrite(bld, out_map, stats, min_vars: int = 4,
                max_vars: int = 10, exact_vars: int = 8,
                max_targets: int = 4000, dc_mine: bool = True):
    """Re-express internal cones (min_vars..max_vars support) as a
    minimized two-level SOP of either phase, mining don't-cares from
    X/Z constants (infer_dc_from_xz) and single-fanout observability
    windows (infer_dc_from_odc), accepting when the MFFC freed exceeds
    the gates added.  The reference runs the same minimization inside
    optimize_qm_two_level_minimize_in_pe_netlist with its dc context
    (pe_synth.h qm pass + espresso_solution)."""
    import numpy as np
    from .opt_graph import (_live_order, _supports, _var_patterns,
                            _qm_primes, _qm_cover, espresso_cover,
                            _build_sop)

    roots = [idx for (_, idx) in out_map.values()]
    root_set = set(roots)
    order = _live_order(bld, roots)
    supp = _supports(bld, order)
    ref: Dict[int, int] = {i: 0 for i in order}
    fan_parents: Dict[int, List[int]] = {}
    for i in order:
        for f in bld.nodes[i].fanins:
            ref[f] = ref.get(f, 0) + 1
            fan_parents.setdefault(f, []).append(i)
    for r in roots:
        ref[r] = ref.get(r, 0) + 1

    leaf_of_bit: Dict[int, int] = {}
    for i in order:
        if bld.nodes[i].op == "PIN":
            leaf_of_bit[supp[i].bit_length() - 1] = i

    repl: Dict[int, int] = {}
    claimed: Set[int] = set()
    global_freed: Set[int] = set()
    tried = 0
    for idx in order:
        n = bld.nodes[idx]
        if n.op not in ("AND", "OR", "XOR") or idx in claimed:
            continue
        s = supp.get(idx, 0)
        nsup = bin(s).count("1")
        if not (min_vars <= nsup <= max_vars):
            continue
        if tried >= max_targets:
            break
        leaves = []
        ok = True
        bit = 0
        u = s
        while u:
            if u & 1:
                l = leaf_of_bit.get(bit)
                if l is None:
                    ok = False
                    break
                leaves.append(l)
            u >>= 1
            bit += 1
        if not ok:
            continue
        # MFFC (full cone to PIN/CONST leaves) via trial deref
        freed: List[int] = [idx]
        dec: List[int] = []

        def deref(j):
            for f in bld.nodes[j].fanins:
                if not _op_node(bld, f):
                    continue
                ref[f] -= 1
                dec.append(f)
                if ref[f] == 0 and f not in claimed:
                    freed.append(f)
                    deref(f)

        deref(idx)
        for f in dec:
            ref[f] += 1
        mffc = sum(1.0 if bld.nodes[j].op != "NOT" else _NOT_W
                   for j in freed)
        if mffc < nsup * 0.8:          # an SOP can rarely beat this
            continue
        tried += 1
        patt, npat, nwords = _var_patterns(nsup)
        pattmap = {l: patt[k] for k, l in enumerate(leaves)}
        ones = np.full(nwords, ~np.uint64(0))
        if npat < 64:
            ones = ones & np.uint64((1 << npat) - 1)
        on, dc = kleene_tt(bld, idx, leaves, npat, pattmap)
        on = on & ones
        dc = dc & ones
        if not getattr(bld, "use_xz_dc", True):
            # X/Z-driven minterms lose their DC license: minimize to
            # the strict 0/1 projection (infer_dc_from_xz off)
            dc = np.zeros_like(dc)
        if dc_mine and idx not in root_set and \
                getattr(bld, "use_odc", True):
            odc = odc_mask(bld, idx, fan_parents, supp, None,
                           pattmap, set(leaves))
            if odc is not None:
                dc = dc | (odc & ones)
        if dc_mine:
            from .opt_graph import _fsm_dc_words
            fdc = _fsm_dc_words(bld, leaves)
            if fdc is not None:
                dc = dc | (np.asarray(fdc, np.uint64) & ones)
        on = on & ~dc
        if int(dc.sum()):
            stats.dc_minterms += int(np.unpackbits(
                dc.view(np.uint8), bitorder="little")[:npat].sum())

        variants = []
        off = ~(on | dc) & ones
        for phase_on, inv in ((on, False), (off, True)):
            bits = np.unpackbits(phase_on.view(np.uint8),
                                 bitorder="little")[:npat]
            mt = np.nonzero(bits)[0]
            if len(mt) == 0:
                variants.append(([], inv))
                continue
            if nsup <= exact_vars:
                dcb = np.unpackbits(dc.view(np.uint8),
                                    bitorder="little")[:npat]
                dmt = [int(m) for m in np.nonzero(dcb)[0]]
                amt = [int(m) for m in mt]
                primes = _qm_primes(amt + dmt, nsup)
                variants.append((_qm_cover(amt, primes, nsup), inv))
            else:
                cov = espresso_cover(phase_on, nsup, dc_words=dc)
                if cov is not None:
                    variants.append((cov, inv))
        best_new = None
        best_gain = 0.0
        freed_all = set(freed)
        for terms, inv in variants:
            n0 = len(bld.nodes)
            cand = _build_sop(bld, leaves, terms, nsup, inv)
            if cand == idx:
                continue
            created = sum(1.0 if bld.nodes[j].op != "NOT" else _NOT_W
                          for j in range(n0, len(bld.nodes)))
            fs = set(freed_all)
            stack = [cand]
            seen: Set[int] = set()
            reuse = 0.0
            while stack:
                j = stack.pop()
                if j in seen:
                    continue
                seen.add(j)
                w = (1.0 if bld.nodes[j].op not in
                     ("NOT", "PIN", "CONST") else
                     (_NOT_W if bld.nodes[j].op == "NOT" else 0.0))
                if j in fs:
                    reuse += w
                    fs.discard(j)
                stack.extend(bld.nodes[j].fanins)
            gain = mffc - reuse - created
            if gain > best_gain + 1e-9:
                best_gain = gain
                best_new = cand
        if best_new is not None:
            repl[idx] = best_new
            claimed.add(idx)
            claimed.update(freed)
            stats.qm_rewritten += 1
            # local gain estimates ignore cross-acceptance sharing:
            # verify in batches and drop a batch that regresses
            if len(repl) % 32 == 0:
                from .opt_graph import _live_gate_count
                trial = _substitute(bld, out_map, repl)
                cur = _live_gate_count(
                    bld, [x for (_, x) in trial.values()])
                base = _live_gate_count(
                    bld, [x for (_, x) in out_map.values()])
                if cur <= base:
                    out_map = trial
                repl = {}
                claimed = set()
    if repl:
        trial = _substitute(bld, out_map, repl)
        from .opt_graph import _live_gate_count
        cur = _live_gate_count(bld, [x for (_, x) in trial.values()])
        base = _live_gate_count(bld, [x for (_, x) in out_map.values()])
        if cur <= base:
            out_map = trial
    return out_map


# ---------------------------------------------------------------------------
# don't-care mining
# ---------------------------------------------------------------------------

def kleene_tt(bld, root: int, leaves: List[int], npat: int, patt):
    """4-state (ON, DC) truth planes of a cone that may contain X/Z
    constants, with binary leaves (infer_dc_from_xz role).  ``patt``:
    per-leaf uint64 pattern arrays.  Returns (on, dc) uint64 arrays."""
    import numpy as np
    shape = patt[leaves[0]].shape if leaves else (1,)
    memo: Dict[int, Tuple] = {}

    def ev(i: int):
        if i in memo:
            return memo[i]
        n = bld.nodes[i]
        if i in patt:
            r = (patt[i].astype(np.uint64), np.zeros(shape, np.uint64))
        elif n.op == "CONST":
            if n.const == 0:
                r = (np.zeros(shape, np.uint64),
                     np.zeros(shape, np.uint64))
            elif n.const == 1:
                r = (np.full(shape, ~np.uint64(0)),
                     np.zeros(shape, np.uint64))
            else:
                r = (np.zeros(shape, np.uint64),
                     np.full(shape, ~np.uint64(0)))
        else:
            f = [ev(x) for x in n.fanins]
            if n.op == "NOT":
                v, u = f[0]
                r = (~v & ~u, u)
            elif n.op == "AND":
                (va, ua), (vb, ub) = f
                ha, la = va & ~ua, ~va & ~ua
                hb, lb = vb & ~ub, ~vb & ~ub
                v = ha & hb
                r = (v, ~(v | la | lb))
            elif n.op == "OR":
                (va, ua), (vb, ub) = f
                ha, la = va & ~ua, ~va & ~ua
                hb, lb = vb & ~ub, ~vb & ~ub
                v = ha | hb
                r = (v, ~(v | (la & lb)))
            else:                                 # XOR
                (va, ua), (vb, ub) = f
                known = ~ua & ~ub
                r = ((va ^ vb) & known, ~known)
        memo[i] = r
        return r

    v, u = ev(root)
    return v & ~u, u


def odc_mask(bld, node: int, fanout, supp, order_pos,
             patt, leaves_set: Set[int], max_depth: int = 3):
    """Observability DC of ``node`` through a single-fanout chain of
    NOT/AND/OR parents: minterms where a sibling holds the controlling
    value.  Requires the sibling's support to live inside the current
    leaf frame.  Returns a uint64 mask array or None."""
    import numpy as np
    parents = fanout.get(node)
    if not parents or len(parents) != 1:
        return None
    odc = None
    cur = node
    for _ in range(max_depth):
        ps = fanout.get(cur)
        if not ps or len(ps) != 1:
            break
        p = ps[0]
        pn = bld.nodes[p]
        if pn.op == "NOT":
            cur = p
            continue
        if pn.op not in ("AND", "OR"):
            break
        sib = pn.fanins[0] if pn.fanins[1] == cur else pn.fanins[1]
        if sib == cur:
            break
        if supp.get(sib) is None or \
                (supp[sib] & ~_supp_mask(supp, leaves_set)):
            break
        sv = _eval_over(bld, sib, patt)
        if sv is None:
            break
        m = (~sv if pn.op == "AND" else sv)
        odc = m if odc is None else (odc | m)
        cur = p
    return odc


def _supp_mask(supp, leaves_set: Set[int]) -> int:
    m = 0
    for l in leaves_set:
        m |= supp.get(l, 0)
    return m


def _eval_over(bld, root: int, patt):
    """Binary evaluation of a cone over pre-assigned leaf patterns;
    None if it hits an unassigned PIN or non-binary const."""
    import numpy as np
    memo: Dict[int, Optional[object]] = {}

    def ev(i: int):
        if i in patt:
            return patt[i]
        if i in memo:
            return memo[i]
        n = bld.nodes[i]
        if n.op == "PIN":
            r = None
        elif n.op == "CONST":
            shape = next(iter(patt.values())).shape
            if n.const == 0:
                r = np.zeros(shape, np.uint64)
            elif n.const == 1:
                r = np.full(shape, ~np.uint64(0))
            else:
                r = None
        else:
            f = [ev(x) for x in n.fanins]
            if any(x is None for x in f):
                r = None
            elif n.op == "NOT":
                r = ~f[0]
            elif n.op == "AND":
                r = f[0] & f[1]
            elif n.op == "OR":
                r = f[0] | f[1]
            else:
                r = f[0] ^ f[1]
        memo[i] = r
        return r

    return ev(root)


# ---------------------------------------------------------------------------
# bounded functional decomposition (pe_synth.h decompose_large_functions
# / optimize_bdd_decompose_large_cones role)
# ---------------------------------------------------------------------------
# Ashenhurst-Curtis via truth-table column multiplicity (the BDD-cut
# formulation computes the same quantity): pick a bound set B of k
# variables; if the 2^k cofactor columns of f take only M distinct
# patterns with ceil(log2(M)) = m < k, then
#     f(B, F) = h(g_1(B) ... g_m(B), F)
# and both pieces re-minimize as small two-level covers.  Variable
# orders are tried a bounded number of times (decomp_var_order_tries).

def _cone_tt_words(bld, root, leaves):
    import numpy as np
    from .opt_graph import _var_patterns, _eval_nodes, _live_order
    nv = len(leaves)
    patt, npat, nwords = _var_patterns(nv)
    leaf_words = {l: patt[k] for k, l in enumerate(leaves)}
    order = _live_order(bld, [root])
    vals = _eval_nodes(bld, order, leaf_words, nwords)
    return np.asarray(vals[root], np.uint64), npat


def _tt_bits(words, npat):
    import numpy as np
    return np.unpackbits(words.view(np.uint8),
                         bitorder="little")[:npat]


def _qm_sop(bld, leaves, on_mt, dc_mt, nvars):
    """Minimized SOP node over ``leaves`` from ON/DC minterm lists."""
    from .opt_graph import _qm_primes, _qm_cover, _build_sop
    if not on_mt:
        return bld.const(0)
    primes = _qm_primes(list(on_mt) + list(dc_mt), nvars)
    cover = _qm_cover(list(on_mt), primes, nvars)
    return _build_sop(bld, leaves, cover, nvars, False)


def bdd_decompose(bld, out_map, stats, min_vars: int = 9,
                  max_vars: int = 14, bound_min: int = 3,
                  bound_max: int = 7, order_tries: int = 4,
                  max_targets: int = 200, seed: int = 11):
    """Decompose wide cones through a small encoder: accepted when the
    rebuilt network frees more gates (MFFC) than it adds."""
    import numpy as np
    from .opt_graph import _live_order, _supports

    roots = [idx for (_, idx) in out_map.values()]
    order = _live_order(bld, roots)
    supp = _supports(bld, order)
    ref: Dict[int, int] = {i: 0 for i in order}
    for i in order:
        for f in bld.nodes[i].fanins:
            ref[f] = ref.get(f, 0) + 1
    for r in roots:
        ref[r] = ref.get(r, 0) + 1
    leaf_of_bit: Dict[int, int] = {}
    for i in order:
        if bld.nodes[i].op == "PIN":
            leaf_of_bit[supp[i].bit_length() - 1] = i

    rng = np.random.default_rng(seed)
    repl: Dict[int, int] = {}
    claimed: Set[int] = set()
    tried = 0
    # roots first: decomposing an interior partial product would claim
    # (and waste) the enclosing cone's much larger opportunity
    for idx in reversed(order):
        n = bld.nodes[idx]
        if n.op not in ("AND", "OR", "XOR") or idx in claimed:
            continue
        s = supp.get(idx, 0)
        nv = bin(s).count("1")
        if not (min_vars <= nv <= max_vars) or tried >= max_targets:
            continue
        leaves = []
        ok = True
        b = 0
        u = s
        while u:
            if u & 1:
                l = leaf_of_bit.get(b)
                if l is None:
                    ok = False
                    break
                leaves.append(l)
            u >>= 1
            b += 1
        if not ok:
            continue
        tried += 1
        try:
            words, npat = _cone_tt_words(bld, idx, leaves)
        except Exception:  # noqa: BLE001 — X consts etc.
            continue
        bits = _tt_bits(words, npat)

        # MFFC of the cone (deref to leaves)
        freed: List[int] = [idx]
        dec: List[int] = []

        def deref(j):
            for f in bld.nodes[j].fanins:
                if not _op_node(bld, f):
                    continue
                ref[f] -= 1
                dec.append(f)
                if ref[f] == 0 and f not in claimed:
                    freed.append(f)
                    deref(f)

        deref(idx)
        for f in dec:
            ref[f] += 1
        mffc = sum(1.0 if bld.nodes[j].op != "NOT" else _NOT_W
                   for j in freed)
        if mffc < nv:
            continue

        best = None
        for t in range(order_tries):
            perm = (np.arange(nv) if t == 0
                    else rng.permutation(nv))
            for k in range(bound_min, min(bound_max, nv - 2) + 1):
                bound = perm[:k]
                free = perm[k:]
                nf = nv - k
                # column c (bound assignment) x row r (free assignment)
                # minterm index: sum over original bit positions
                cols = np.zeros((1 << k,), np.int64)
                tt = bits.reshape([2] * nv, order="F")
                # axis v corresponds to leaf v (LSB-first, F-order)
                mat = np.moveaxis(tt, list(perm),
                                  list(range(nv)))
                mat = mat.reshape((1 << k, 1 << nf), order="F")
                pats, codes = np.unique(mat, axis=0,
                                        return_inverse=True)
                M = pats.shape[0]
                m = max(1, int(np.ceil(np.log2(max(M, 2)))))
                if m >= k:
                    continue
                # cost estimate: g_i over k vars, h over nf+m vars
                score = (M, m, k)
                if best is None or score < best[0]:
                    best = (score, perm, k, pats, codes)
            if best is not None and best[0][0] <= 2:
                break
        if best is None:
            continue
        (_sc, perm, k, pats, codes) = best
        nf = nv - k
        m = max(1, int(np.ceil(np.log2(max(pats.shape[0], 2)))))
        bound_leaves = [leaves[perm[i]] for i in range(k)]
        free_leaves = [leaves[perm[i]] for i in range(k, nv)]

        n0 = len(bld.nodes)
        # encoder bits g_j(B): TT over the bound set
        g_nodes = []
        for j in range(m):
            on = [c for c in range(1 << k) if (codes[c] >> j) & 1]
            g_nodes.append(_qm_sop(bld, bound_leaves, on, [], k))
        # composer h(F, g): minterms over nf + m vars; codes >= M are DC
        h_leaves = free_leaves + g_nodes
        on_mt = []
        dc_mt = []
        for c in range(1 << m):
            for r in range(1 << nf):
                mt = r | (c << nf)
                if c >= pats.shape[0]:
                    dc_mt.append(mt)
                elif pats[c, r]:
                    on_mt.append(mt)
        cand = _qm_sop(bld, h_leaves, on_mt, dc_mt, nf + m)
        if cand == idx:
            continue
        created = sum(1.0 if bld.nodes[j].op != "NOT" else _NOT_W
                      for j in range(n0, len(bld.nodes)))
        fs = set(freed)
        stack = [cand]
        seen: Set[int] = set()
        reuse = 0.0
        while stack:
            j = stack.pop()
            if j in seen:
                continue
            seen.add(j)
            if j in fs:
                reuse += (1.0 if bld.nodes[j].op != "NOT" else _NOT_W)
                fs.discard(j)
            stack.extend(bld.nodes[j].fanins)
        if mffc - reuse - created <= 1e-9:
            continue
        repl[idx] = cand
        claimed.add(idx)
        claimed.update(freed)
        stats.bdd_decomposed += 1
    if not repl:
        return out_map
    new_map = _substitute(bld, out_map, repl)
    from .opt_graph import _live_gate_count
    cur = _live_gate_count(bld, [x for (_, x) in new_map.values()])
    base = _live_gate_count(bld, [x for (_, x) in out_map.values()])
    return new_map if cur <= base else out_map
