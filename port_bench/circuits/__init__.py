"""Circuit families: one module each, found by the ``circuit`` name in a
configuration file (``configs/<config>.json``).  Adding a family is adding
its file; no other file of the harness names one.

A family module holds the system under test for its circuits, the
comparison with its plain reference (``reference/``), and these names:

- ``RATE``: (name, unit) of the end-to-end rate its cells report;
- ``FAILED``: the name under which the check holds the window's count of
  failed answers;
- ``ZERO``: the numbers compared that are held to 0 in every cell
  (``FAILED`` and the reference's own failures);
- ``Bench(c, seed, device)``: the set-up of a cell ``c`` (a ``spec.Cell``),
  warm-up included, with
  - ``work``: units of ``RATE`` that one job completes,
  - ``answers``: answers one job gives (lanes, solves), the result's
    ``attempted`` and ``failed`` count them,
  - ``steps``: steps of one job, the unit of the per-step readers,
  - ``job(seed, j)``: run job j of the seed's traffic and return, without
    waiting, (what the check keeps of it, its count of failures), both
    on the device,
  - ``counters()``: the program's cumulative counters that the readers
    read, as {name: number},
  - ``marks(calls)``: a context manager around the traced job that
    records the program's calls the readers need into ``calls``,
  - ``compare(seed, kept, control=False)``: after the window, the
    numbers compared, {name: value}, from ``kept`` (the host copies of
    every job's kept answers, in job order), run against the reference;
    with ``control``, the numbers of the reference in the next lower
    precision put in the program's place.
"""
