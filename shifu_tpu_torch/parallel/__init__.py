"""The device mesh over ``torch.distributed`` (:mod:`.mesh`) — the port of
``shifu_tpu.parallel.mesh`` — and the elastic multi-controller step
protocol (:mod:`.elastic`, with its demo controller
:mod:`.elastic_demo`), the port of ``shifu_tpu.parallel.elastic``."""

from .mesh import Mesh, device_mesh  # noqa: F401
