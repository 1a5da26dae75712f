"""wukong_tpu_torch: the PyTorch/CUDA port of wukong_tpu for NVIDIA Hopper.

Same file layout and public names as the JAX package (``wukong_tpu``), which
stays the reference; the port imports none of it. Entry points
(``runtime.console`` — ``python -m wukong_tpu_torch.runtime.console <config>
<dataset>`` —, ``runtime.proxy.Proxy``, ``engine.tpu.GPUEngine``,
``engine.device_store.DeviceStore``) run on the card by default and on the
CPU only when the caller passes ``device="cpu"`` (``--device cpu``). The hand-written kernels
live in ``csrc/`` and build at first use into ``build/``. ``Proxy.serve_query``
answers every query shape the JAX engine answers on one partition (basic
patterns, variable predicates, attributes, OPTIONAL, UNION, FILTER, ORDER BY).
"""

__version__ = "0.1.0"
