"""Communication accounting and the weak-scaling model of the sharded paths:
the port's counterpart of the JAX package's `parallel/comm_model.py`
(`collective_inventory` :123, `predict_efficiency` :147).

1. `collective_inventory(fn, *args)` is the measured side: it runs `fn`
   under `mesh.recording()` and returns every gather the run made, with
   its shape and logical bytes.  The JAX package reads the same list from
   the program's lowered or compiled HLO; a torch program has no HLO, so
   the port records by running (its HLO parsers, `_tensor_bytes`,
   `_shape_bytes` and `collective_inventory_from_text`, have no
   counterpart).

2. `predict_efficiency(...)` is the written model, the JAX package's
   formula for one point-sharded MSM over D devices of n points each:

       T_comp = n / chip_points_per_sec
       T_comm = alpha_link_s * ceil(log2 D) + coll_bytes_per_device * D / bw
       T_fold = ceil(log2 D) * ecadd_row_s
       efficiency = T_comp / (T_comp + T_comm + T_fold)

   It has no default taken on or for a TPU: the MSM rate, the link latency
   and the time of one fold level are measured on the device by the
   caller (`chip_smoke.py` passes its own run's).  The one default is the
   NVLink bandwidth of the H100 data sheet, 450 GB/s each way
   (`NVLINK_BYTES_PER_S`), and the gathered bytes of the port's layout: a
   (3, 8)-word projective partial (96 B) and an overflow flag (1 B).
"""

from __future__ import annotations

import math
from typing import Any, Dict

from .mesh import recording

NVLINK_BYTES_PER_S = 450e9  # H100 SXM data sheet: 900 GB/s both ways, 450 each way
PARTIAL_BYTES = 3 * 8 * 4 + 1  # a (3, 8) int32 partial and its overflow flag


def collective_inventory(fn, *args, **kw) -> Dict[str, Any]:
    """Run fn(*args, **kw) and account its gathers -> {ops: [{op, type,
    bytes}], count, total_bytes}: the communication of one step."""
    with recording() as ops:
        fn(*args, **kw)
    return {"ops": ops, "count": len(ops), "total_bytes": sum(o["bytes"] for o in ops)}


def predict_efficiency(n_per_device: int, n_devices: int, chip_points_per_sec: float, *,
                       alpha_link_s: float, ecadd_row_s: float,
                       coll_bytes_per_device: int = PARTIAL_BYTES,
                       bw_bytes_per_sec: float = NVLINK_BYTES_PER_S) -> Dict[str, float]:
    """Weak-scaling efficiency of the point-sharded MSM (the module's
    model): chip_points_per_sec is one device's MSM rate at n_per_device,
    alpha_link_s a gather's fixed latency, ecadd_row_s one fold level's
    time, all measured by the caller on the device."""
    hops = max(1, math.ceil(math.log2(max(n_devices, 2))))
    t_comp = n_per_device / chip_points_per_sec
    v = coll_bytes_per_device * n_devices
    t_comm = alpha_link_s * hops + v / bw_bytes_per_sec
    t_fold = hops * ecadd_row_s
    eff = t_comp / (t_comp + t_comm + t_fold)
    return {
        "t_comp_s": t_comp,
        "t_comm_s": t_comm,
        "t_fold_s": t_fold,
        "gather_bytes": v,
        "efficiency": eff,
    }
