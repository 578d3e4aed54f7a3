"""Cells of the benchmark cut to a size that a CPU test can run.

Their limits are their own.  At 31 stages and 10 steps the transient's
answers sit within 1e-5 of the reference (its Newton stops at the SPICE
tolerances), so the tiny transient holds them to 1e-4, and its widest lane
to 1e-3, which every planted fault passes by orders of magnitude.  At
2,000 nodes the DC solve's answers sit within 2e-6 of the reference (its
BiCGStab stops at a relative residual of 1e-10), held to 1e-5.  At
2,000 resistors the ladder's answers sit within 1e-12 of the reference
(both are direct solves), held to 1e-9.  The cells' own limits are set
from card readings."""

from port_bench import spec


def cell(name="ladder255.mc4096", stages=31, links=31, lanes=4, steps=10,
         check_lanes=3):
    c = spec.cell(name)
    chk = dict(c.cell["check"], lanes=check_lanes, block=2,
               limits={"x_gap_p90": 1e-4, "x_gap_max": 1e-3})
    return spec.Cell(name=f"{name}.tiny", cell=dict(c.cell, check=chk),
                     config=dict(c.config, stages=stages, links=links),
                     traffic=dict(c.traffic, lanes=lanes, steps=steps))


def mesh_cell(name="mesh100k.dc", nodes=2000, links=200, lanes=3,
              positions=64):
    c = spec.cell(name)
    chk = dict(c.cell["check"], positions=positions,
               limits={"v_gap_max": 1e-5, "i_gap_max": 1e-5})
    return spec.Cell(name=f"{name}.tiny", cell=dict(c.cell, check=chk),
                     config=dict(c.config, nodes=nodes, links=links),
                     traffic=dict(c.traffic, lanes=lanes))


def series_cell(name="ladder1e6.dc", resistors=2000, lanes=3, positions=64):
    c = spec.cell(name)
    chk = dict(c.cell["check"], positions=positions,
               limits={"v_gap_max": 1e-9, "i_gap_max": 1e-9})
    return spec.Cell(name=f"{name}.tiny", cell=dict(c.cell, check=chk),
                     config=dict(c.config, resistors=resistors),
                     traffic=dict(c.traffic, lanes=lanes))
