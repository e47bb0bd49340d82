"""The multi-pod dry run: not ported yet (``ROADMAP.md`` Queue 1 item 17).

The reference lowers and compiles every architecture x input-shape cell
on 512 placeholder devices (its ``launch/dryrun.py``), reads the compiled
programs' FLOPs, bytes and collectives (``launch/hlo_analysis.py``) and
turns them into roofline terms (``launch/roofline.py``).  Its
PyTorch counterpart builds each cell's step on ``meta`` tensors over a
256- or 512-rank fake process group, counting FLOPs with
``FlopCounterMode`` and collectives with ``CommDebugMode``, with the
layouts of :mod:`repro_torch.launch.sharding` as DTensor placements and
the card's constants for the roofline.  Until then each entry raises.
"""

from __future__ import annotations

from repro_torch.models.param import unported_fn

lower_cell = unported_fn("lower_cell", item=17)
lower_em_cell = unported_fn("lower_em_cell", item=17)
analyze = unported_fn("hlo_analysis.analyze", item=17)
roofline_terms = unported_fn("roofline.terms", item=17)
