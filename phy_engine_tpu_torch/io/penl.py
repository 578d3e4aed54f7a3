"""Netlist persistence + checkpoint/resume (the port's copy of
``phy_engine_tpu/io/penl.py``; the file format is shared: a ``.penl``
written by either package loads in the other to the same netlist, with
the same stable IDs).

Capability parity with ``pe_nl_fileformat/`` (SURVEY.md §2.6):

* export modes ``full`` / ``structure_only`` / ``runtime_only`` (the
  latter is a *checkpoint*: all model runtime state — companion
  histories, Verilog instance state, branch currents — keyed by stable
  graph IDs so it can re-attach to a matching netlist);
* stable 64-bit IDs by FNV-1a hashing of topology
  (pe_nl_fileformat.h:81-130), match by ``stable_id`` or ``sequence``;
* layouts: ``single_file`` (one JSON document with an FNV-1a content
  checksum, mirroring the archive checksums of archive.h:19-31) or
  ``directory`` (structure.json + runtime.json).

Storage is JSON + base-16 payloads rather than LevelDB: the data volume
is host-side netlist metadata (device tensors are reconstructed by
lowering), so an embedded KV store buys nothing.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..netlist.netlist import Netlist, ModelInstance
from ..netlist import operations as ops
from ..models.base import MODEL_REGISTRY

FNV_OFFSET = 0xcbf29ce484222325
FNV_PRIME = 0x100000001b3
MASK64 = (1 << 64) - 1


def _fnv1a(data: bytes, h: int = FNV_OFFSET) -> int:
    for b in data:
        h ^= b
        h = (h * FNV_PRIME) & MASK64
    return h


@dataclass
class SaveOptions:
    mode: str = "full"            # full | structure_only | runtime_only
    layout: str = "single_file"   # single_file | directory


@dataclass
class LoadOptions:
    checkpoint_match: str = "stable_id"    # stable_id | sequence


def _node_indices(nl: Netlist) -> Dict[int, int]:
    idx = {id(nl.ground_node): -1}
    for i, n in enumerate(nl.nodes):
        idx[id(n)] = i
    return idx


def compute_stable_ids(nl: Netlist) -> List[int]:
    """FNV-1a over each model's topology (type + pin connectivity +
    sequence among identical hashes), pe_nl_fileformat.h:107+."""
    nidx = _node_indices(nl)
    raw = []
    for inst in nl.models:
        if inst is None:
            raw.append(None)
            continue
        h = _fnv1a(inst.mdef.id_name.encode())
        for pin in inst.pins:
            i = nidx.get(id(pin.node), -2) if pin.node is not None else -3
            h = _fnv1a(int(i).to_bytes(8, "little", signed=True), h)
        raw.append(h)
    # disambiguate identical hashes by occurrence index
    seen: Dict[int, int] = {}
    out = []
    for h in raw:
        if h is None:
            out.append(None)
            continue
        k = seen.get(h, 0)
        seen[h] = k + 1
        out.append(_fnv1a(k.to_bytes(4, "little"), h))
    return out


def _serialize_params(inst: ModelInstance) -> Dict[str, Any]:
    out = {}
    for k, v in inst.params.items():
        if k.startswith("_"):
            continue
        out[k] = v
    return out


def _runtime_payload(inst: ModelInstance) -> Dict[str, Any]:
    rt: Dict[str, Any] = {}
    for k, v in inst.runtime.items():
        if isinstance(v, (int, float)):
            rt[k] = v
    if inst.mdef.id_name == "VERILOG":
        vrt = inst.runtime.get("rt")
        if vrt is not None:
            sigvals = {}
            from ..verilog.fourstate import Val

            def dump_rt(r, prefix=""):
                for name, val in r.values.items():
                    if isinstance(val, Val):
                        sigvals[prefix + name] = [val.v, val.u, val.width]
                    elif isinstance(val, list):
                        sigvals[prefix + name] = [
                            [x.v, x.u, x.width] for x in val]
                for i, c in enumerate(r.children):
                    dump_rt(c, f"{prefix}{i}/")
            dump_rt(vrt)
            rt["_verilog_signals"] = sigvals
            rt["_tick"] = inst.runtime.get("tick", 0)
    branches = [[br.current.real, br.current.imag] for br in inst.branches]
    return {"state": rt, "branches": branches}


def _apply_runtime(inst: ModelInstance, payload: Dict[str, Any]):
    for k, v in payload.get("state", {}).items():
        if k == "_verilog_signals":
            vrt = inst.runtime.get("rt")
            if vrt is None:
                continue
            from ..verilog.fourstate import Val

            def load_rt(r, prefix=""):
                for name in list(r.values.keys()):
                    key = prefix + name
                    if key not in v:
                        continue
                    enc = v[key]
                    if enc and isinstance(enc[0], list):
                        r.values[name] = [Val(int(e[0]), int(e[1]),
                                              int(e[2])) for e in enc]
                    else:
                        r.values[name] = Val(int(enc[0]), int(enc[1]),
                                             int(enc[2]))
                for i, c in enumerate(r.children):
                    load_rt(c, f"{prefix}{i}/")
            load_rt(vrt)
        elif k == "_tick":
            inst.runtime["tick"] = int(v)
        else:
            inst.runtime[k] = v
    for br, (re_, im_) in zip(inst.branches,
                              payload.get("branches", [])):
        br.current = complex(re_, im_)


def _document(circuit_or_nl, opt: SaveOptions) -> Dict[str, Any]:
    from ..engine.circuit import Circuit
    circuit = circuit_or_nl if isinstance(circuit_or_nl, Circuit) else None
    nl = circuit.nl if circuit else circuit_or_nl
    sids = compute_stable_ids(nl)
    nidx = _node_indices(nl)

    doc: Dict[str, Any] = {"format": "penl-tpu", "version": 1,
                           "mode": opt.mode}
    if opt.mode in ("full", "structure_only"):
        models = []
        for inst, sid in zip(nl.models, sids):
            if inst is None:
                continue
            rec = {
                "type": inst.mdef.id_name,
                "name": inst.name,
                "describe": inst.describe,
                "stable_id": sid,
                "params": _serialize_params(inst),
                "pins": [nidx.get(id(p.node), -3) if p.node is not None
                         else -3 for p in inst.pins],
            }
            if inst.mdef.id_name == "VERILOG":
                rec["verilog_source"] = inst.runtime.get("source", "")
                rec["verilog_top"] = inst.runtime.get("top", "")
            models.append(rec)
        doc["n_nodes"] = len(nl.nodes)
        doc["node_names"] = [n.name for n in nl.nodes]
        doc["models"] = models
    if opt.mode in ("full", "runtime_only"):
        runtime = []
        for seq, (inst, sid) in enumerate(zip(nl.models, sids)):
            if inst is None:
                continue
            runtime.append({"stable_id": sid, "sequence": seq,
                            "payload": _runtime_payload(inst)})
        doc["runtime"] = runtime
        doc["node_voltages"] = [[n.voltage.real, n.voltage.imag]
                                for n in nl.nodes]
        doc["node_digital"] = [n.digital for n in nl.nodes]
        if circuit is not None:
            doc["analysis"] = {
                "type": circuit.at.name,
                "tr_duration": circuit.tr_duration,
                "tr": {"t_stop": circuit.tr.t_stop,
                       "t_step": circuit.tr.t_step},
                "ac": {"sweep": circuit.ac.sweep.name,
                       "omega": circuit.ac.omega,
                       "omega_start": circuit.ac.omega_start,
                       "omega_stop": circuit.ac.omega_stop,
                       "points": circuit.ac.points},
            }
            env = circuit.env
            doc["environment"] = {
                k: getattr(env, k) for k in (
                    "V_eps_max", "V_epsr_max", "I_eps_max", "I_epsr_max",
                    "charge_eps_max", "g_min", "r_open", "t_TOEF",
                    "temperature", "norm_temperature")}
    return doc


def save(path: str, circuit_or_nl, options: Optional[SaveOptions] = None):
    opt = options or SaveOptions()
    doc = _document(circuit_or_nl, opt)
    if opt.layout == "directory":
        os.makedirs(path, exist_ok=True)
        struct = {k: v for k, v in doc.items()
                  if k not in ("runtime", "node_voltages", "node_digital",
                               "analysis", "environment")}
        runtime = {k: v for k, v in doc.items()
                   if k in ("format", "version", "mode", "runtime",
                            "node_voltages", "node_digital", "analysis",
                            "environment")}
        with open(os.path.join(path, "structure.json"), "w") as f:
            json.dump(struct, f)
        with open(os.path.join(path, "runtime.json"), "w") as f:
            json.dump(runtime, f)
        return
    body = json.dumps(doc, separators=(",", ":"))
    checksum = _fnv1a(body.encode())
    with open(path, "w") as f:
        json.dump({"checksum": checksum, "body": doc},
                  f, separators=(",", ":"))


class LoadError(Exception):
    pass


def _read_doc(path: str) -> Dict[str, Any]:
    if os.path.isdir(path):
        doc = {}
        with open(os.path.join(path, "structure.json")) as f:
            doc.update(json.load(f))
        rj = os.path.join(path, "runtime.json")
        if os.path.exists(rj):
            with open(rj) as f:
                doc.update(json.load(f))
        return doc
    with open(path) as f:
        outer = json.load(f)
    body = outer.get("body", outer)
    if "checksum" in outer:
        expect = _fnv1a(json.dumps(
            body, separators=(",", ":")).encode())
        if expect != outer["checksum"]:
            raise LoadError("checksum mismatch")
    return body


def load(path: str, circuit=None, options: Optional[LoadOptions] = None,
         device="cuda"):
    """Load a netlist (and state).  Returns a Circuit.

    If ``circuit`` is given and the file is a ``runtime_only``
    checkpoint, the state re-attaches to the existing netlist by
    stable_id or sequence (load_options, pe_nl_fileformat.h:59-65).
    Without ``circuit`` the netlist goes into a new Circuit on
    ``device``.
    """
    from ..engine.circuit import Circuit, AnalyzeType, ACSweepType
    opt = options or LoadOptions()
    doc = _read_doc(path)

    if doc.get("mode") == "runtime_only":
        if circuit is None:
            raise LoadError("runtime_only checkpoint needs a circuit")
        c = circuit
    elif circuit is not None:
        c = circuit
    else:
        c = Circuit(device=device)

    nl = c.nl
    if "models" in doc:
        nodes = [ops.create_node(nl, name)
                 for name in doc.get("node_names", [])]
        for rec in doc["models"]:
            mdef = MODEL_REGISTRY.get(rec["type"])
            if mdef is None:
                raise LoadError(f"unknown model type {rec['type']!r}")
            if rec["type"] == "VERILOG":
                from ..models.verilog_module import make_verilog_module
                inst = make_verilog_module(rec["verilog_source"],
                                           top=rec["verilog_top"] or None,
                                           name=rec.get("name", ""))
            else:
                inst = ModelInstance(mdef, rec["params"],
                                     rec.get("name", ""))
            inst.describe = rec.get("describe", "")
            ops.add_model(nl, inst)
            for pi, ni in enumerate(rec["pins"]):
                if ni == -3:
                    continue
                node = nl.ground_node if ni == -1 else nodes[ni]
                ops.add_to_node(nl, inst, pi, node)

    if "runtime" in doc:
        live = [(seq, inst) for seq, inst in enumerate(nl.models)
                if inst is not None]
        sids = compute_stable_ids(nl)
        by_sid = {}
        for seq, inst in live:
            by_sid.setdefault(sids[seq], []).append(inst)
        by_seq = {seq: inst for seq, inst in live}
        for rec in doc["runtime"]:
            inst = None
            if opt.checkpoint_match == "stable_id":
                lst = by_sid.get(rec["stable_id"])
                if lst:
                    inst = lst.pop(0)
            if inst is None:
                inst = by_seq.get(rec["sequence"])
            if inst is None:
                continue
            _apply_runtime(inst, rec["payload"])
        for i, (re_, im_) in enumerate(doc.get("node_voltages", [])):
            if i < len(nl.nodes):
                nl.nodes[i].voltage = complex(re_, im_)
        for i, d in enumerate(doc.get("node_digital", [])):
            if i < len(nl.nodes):
                nl.nodes[i].digital = int(d)
        if "analysis" in doc:
            a = doc["analysis"]
            c.at = AnalyzeType[a["type"]]
            c.tr_duration = a["tr_duration"]
            c.tr.t_stop = a["tr"]["t_stop"]
            c.tr.t_step = a["tr"]["t_step"]
            c.ac.sweep = ACSweepType[a["ac"]["sweep"]]
            c.ac.omega = a["ac"]["omega"]
            c.ac.omega_start = a["ac"]["omega_start"]
            c.ac.omega_stop = a["ac"]["omega_stop"]
            c.ac.points = a["ac"]["points"]
        if "environment" in doc:
            for k, v in doc["environment"].items():
                setattr(c.env, k, v)
    return c
