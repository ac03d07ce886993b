"""One step of the lane-aligned drain's bookkeeping, between two launches of
the chunked megakernel.

No TPU kernel stands behind this module: the JAX package's drain
(``ops/megalanes.py:74-122``) runs its loop body as XLA fusions inside one
``jax.lax.while_loop``.  Its counterpart here is ``drain_step``, one
hand-written CUDA kernel (``csrc/drain.cu``) over the chunk's lanes, so that
a step of ``ops.megalanes`` is two launches, K6 and this one, and reads
nothing on the host.  ``drain_step_plain`` is the same function in plain
PyTorch.  ``drain_step`` uses it only for tensors that lie on the CPU; for
CUDA tensors it launches the kernel or raises.

The state (``DrainState``) lives on the device and is updated in place, one
lane a column: ``cur`` (16, C) the record each lane traces next (pool
layout, ``kernels.mega``), ``lane`` (C,) the lane ids (-1: dead), ``omt`` (C,)
each lane's 1 - time_ratio, ``queue`` (Q, 8, C) the per-lane stacks (o, d,
contribution, bounce count) with ``qsize`` (C,), ``color`` (3, C),
``primary_t`` (C,), ``rays`` (C,) the per-lane ray-tree size, ``iters`` (the
chunk's steps that began with a live lane) and ``dropped`` (stack overflows).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from raytracing_tests_tpu_torch.kernels import _build
from raytracing_tests_tpu_torch.kernels.mega import (
    MISC_ROWS, P_BOUNCED, P_CONTRIB, P_OMT, POOL_ROWS,
)

QUEUE_ROWS = 8  # o(3) d(3) contrib bounced: what a stacked record keeps


@dataclasses.dataclass
class DrainState:
    cur: torch.Tensor
    lane: torch.Tensor
    omt: torch.Tensor
    queue: torch.Tensor
    qsize: torch.Tensor
    color: torch.Tensor
    primary_t: torch.Tensor
    rays: torch.Tensor
    iters: torch.Tensor
    dropped: torch.Tensor

    @classmethod
    def create(cls, C: int, Q: int, device) -> "DrainState":
        """A state for chunks of ``C`` lanes and stacks of ``Q`` records;
        ``load`` fills it for a chunk.  ``dropped`` starts at 0 and is never
        reset by ``load``: it sums over the chunks drained with this state."""
        f32, i32 = torch.float32, torch.int32
        return cls(
            cur=torch.zeros((POOL_ROWS, C), dtype=f32, device=device),
            lane=torch.full((C,), -1, dtype=i32, device=device),
            omt=torch.zeros((C,), dtype=f32, device=device),
            queue=torch.zeros((Q, QUEUE_ROWS, C), dtype=f32, device=device),
            qsize=torch.zeros((C,), dtype=i32, device=device),
            color=torch.zeros((3, C), dtype=f32, device=device),
            primary_t=torch.zeros((C,), dtype=f32, device=device),
            rays=torch.zeros((C,), dtype=i32, device=device),
            iters=torch.zeros((), dtype=i32, device=device),
            dropped=torch.zeros((), dtype=torch.int64, device=device))

    @property
    def lanes(self) -> int:
        return self.cur.shape[1]

    @property
    def capacity(self) -> int:
        return self.queue.shape[0]

    def load(self, cur, lane, t_max: float) -> None:
        """Start a chunk: its primary records ``cur`` (16, C) and lane ids
        ``lane`` (C,) are copied in; the stacks, colour, rays and the
        iteration counter emptied."""
        self.cur.copy_(cur)
        self.lane.copy_(lane)
        self.omt.copy_(cur[P_OMT])
        self.qsize.zero_()
        self.color.zero_()
        self.primary_t.fill_(t_max)
        self.rays.zero_()
        self.iters.zero_()


def _check(st: DrainState, misc, refr, refl, rlane, llane, step: int):
    C, Q, dev = st.lanes, st.capacity, st.cur.device
    f32, i32 = torch.float32, torch.int32
    want = dict(cur=(f32, (POOL_ROWS, C)), lane=(i32, (C,)), omt=(f32, (C,)),
                queue=(f32, (Q, QUEUE_ROWS, C)), qsize=(i32, (C,)), color=(f32, (3, C)),
                primary_t=(f32, (C,)), rays=(i32, (C,)), iters=(i32, ()),
                dropped=(torch.int64, ()))
    got = {k: getattr(st, k) for k in want}
    got.update(misc=misc, refr=refr, refl=refl, rlane=rlane, llane=llane)
    want.update(misc=(f32, (MISC_ROWS, C)), refr=(f32, (POOL_ROWS, C)),
                refl=(f32, (POOL_ROWS, C)), rlane=(i32, (C,)), llane=(i32, (C,)))
    for name, (dtype, shape) in want.items():
        t = got[name]
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} "
                             f"(contiguous: {t.is_contiguous()}), expected {dtype} {shape} "
                             f"contiguous on {dev}")
    if step < 0:
        raise ValueError(f"step = {step}")
    return C, Q, dev


def drain_step_plain(st: DrainState, misc, refr, refl, rlane, llane, *, step: int,
                     t_max: float) -> None:
    """Plain PyTorch version of the kernel: see ``drain_step``."""
    C, Q, dev = _check(st, misc, refr, refl, rlane, llane, step)
    lane = st.lane
    active = lane >= 0
    st.color.add_(misc[0:3])  # K6 adds 0 for inactive lanes
    if step == 0:
        st.primary_t.copy_(torch.where(active, misc[3], st.primary_t))
    st.rays.add_(active.to(torch.int32))  # per-lane ray-tree size
    st.iters.copy_(torch.maximum(st.iters, active.any().to(torch.int32) * (step + 1)))

    has_refl = llane >= 0
    has_refr = rlane >= 0

    # Both children: the refraction waits on the per-lane stack while the
    # reflection continues in place (reference LIFO order).
    qsize = st.qsize
    push = has_refl & has_refr
    can = qsize < Q
    do_push = push & can
    st.dropped.add_(torch.sum(push & ~can))
    refr8 = torch.cat([refr[0:6], refr[P_CONTRIB:P_BOUNCED + 1]])
    oh_push = (torch.arange(Q, device=dev)[:, None] == qsize[None]) & do_push[None]
    st.queue.copy_(torch.where(oh_push[:, None], refr8[None], st.queue))
    qsize = qsize + do_push.to(torch.int32)

    # Continue in place, else pop the stack, else the lane dies.
    need_pop = active & ~has_refl & ~has_refr
    do_pop = need_pop & (qsize > 0)
    top = torch.clamp_min(qsize - 1, 0).long()
    popped8 = torch.gather(st.queue, 0, top.expand(1, QUEUE_ROWS, C))[0]
    popped8 = torch.where(do_pop, popped8, torch.zeros_like(popped8))
    qsize = qsize - do_pop.to(torch.int32)
    z = torch.zeros((1, C), dtype=torch.float32, device=dev)
    popped = torch.cat([popped8[0:6], st.omt[None], torch.full_like(z, t_max), popped8[6:8],
                        z.expand(POOL_ROWS - 10, C)])
    nxt = torch.where(has_refl, refl, torch.where(has_refr, refr, popped))
    st.cur.copy_(torch.where(active, nxt, st.cur))  # a dead lane keeps its record
    st.qsize.copy_(qsize)
    lane.copy_(torch.where(has_refl | has_refr | do_pop, lane, torch.full_like(lane, -1)))


def _launch_drain(st: DrainState, misc, refr, refl, rlane, llane, *, step: int,
                  t_max: float) -> None:
    """Check the arguments and launch ``csrc/drain.cu`` on the current
    stream; the state is updated in place."""
    C, Q, dev = _check(st, misc, refr, refl, rlane, llane, step)
    _build.check_device(dev)
    fn = _build.load("drain").rt_drain_step
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * 15 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_float, p]
        fn.restype = ctypes.c_int
    code = fn(st.cur.data_ptr(), st.lane.data_ptr(), st.omt.data_ptr(), st.queue.data_ptr(),
              st.qsize.data_ptr(), st.color.data_ptr(), st.primary_t.data_ptr(),
              st.rays.data_ptr(), st.iters.data_ptr(), st.dropped.data_ptr(),
              misc.data_ptr(), refr.data_ptr(), refl.data_ptr(), rlane.data_ptr(),
              llane.data_ptr(), C, Q, step, t_max, _build.stream_of(dev))
    _build.check(code, "rt_drain_step")
    _build.LAUNCHES["drain_step"] += 1


def drain_step(st: DrainState, misc, refr, refl, rlane, llane, *, step: int,
               t_max: float) -> None:
    """One step of the drain after K6's launch on ``st.cur`` / ``st.lane``.

    ``misc``, ``refr``, ``refl``, ``rlane``, ``llane``: ``mega.mega_step``'s
    outputs.  Where the lane was live when the step began: colour += misc[0:3],
    ``primary_t`` = misc[3] on step 0, ``rays`` += 1; where both children
    spawn the refraction child's 8 kept rows are pushed at ``qsize`` if the
    stack has room (else ``dropped`` += 1); the lane then continues with the
    reflection, else the refraction, else pops its stack (the record rebuilt
    with its ``omt``, ``t_max`` and zeros), else dies (``lane`` = -1, a dead
    record).  A lane dead when the step began is left as it is.  ``iters``
    becomes at least ``step`` + 1 where any lane was live.

    CPU tensors go through ``drain_step_plain``; CUDA tensors launch the
    kernel of ``csrc/drain.cu`` (counted as ``drain_step``) or raise.  The
    two agree bit for bit."""
    if st.cur.device.type == "cpu":
        return drain_step_plain(st, misc, refr, refl, rlane, llane, step=step, t_max=t_max)
    with torch.cuda.device(st.cur.device):
        return _launch_drain(st, misc, refr, refl, rlane, llane, step=step, t_max=t_max)
