"""The device mesh over ``torch.distributed`` (:mod:`.mesh`) — the port of
``shifu_tpu.parallel.mesh``.  The reference's elastic multi-controller
step protocol (``parallel/elastic.py``) is not ported yet (ROADMAP Queue 1
item 12)."""

from .mesh import Mesh, device_mesh  # noqa: F401
