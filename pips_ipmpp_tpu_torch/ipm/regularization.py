r"""Regularization strategies (reference RegularizationStrategy.h:15-38,
FriedlanderOrbanRegularization.cpp, IpoptRegularization.cpp).

Counterpart of `pips_ipmpp_tpu/ipm/regularization.py`.  The failure signal
is `factorization_ok` (non-finite factors / wrong pivot signs in the
quasidefinite LDL), which plays the role of the reference's inertia test;
the escalation schedules are kept verbatim.

The state is a `(delta_p, delta_d, aux)` triple of scalar tensors on the
device and every transition is a tensor operation, so one strategy object
drives both the host loop (ipm/solver.py), which reads the state back
where it decides, and the fused loop (ipm/device_loop.py), which never
does.  `attempt` and `mu` may be Python numbers or device tensors.

API:
  init_state(dtype, device)     -> state
  new_step(state)               -> state   # at the start of a fresh IPM
                                           # iteration (NOT on retries)
  on_failure(state, mu, attempt)-> state   # after a failed factorization
  deltas(state)                 -> (delta_p, delta_d)
  give_up(state)                -> bool    # escalation exhausted
"""
from __future__ import annotations

import torch


def _zero(dtype, device):
    return torch.zeros((), dtype=dtype, device=device)


class GrowthLadder:
    """Constant base shifts, multiplied by `growth` on every failed
    factorization."""

    def __init__(self, base_p: float = 1e-10, base_d: float = 1e-10,
                 growth: float = 100.0, max_delta: float = 1e2,
                 f32_jump_floor: float = 1e-2):
        self.base_p, self.base_d = base_p, base_d
        self.growth = growth
        self.max_delta = max_delta
        # In f32, growth rungs below ~1e-4 never rescue a failed
        # factorization of the equilibrated KKT system, so the first
        # escalation jumps straight to f32_jump_floor; f64 keeps the
        # gentle ladder.
        self.f32_jump_floor = f32_jump_floor

    def init_state(self, dtype, device="cpu"):
        z = _zero(dtype, device)
        floor = self.f32_jump_floor if dtype == torch.float32 else 0.0
        return (z + self.base_p, z + self.base_d, z + floor)

    def new_step(self, state):
        return state  # sticky: keep the escalated level

    def on_failure(self, state, mu, attempt):
        dp, dd, floor = state
        return (torch.maximum(dp * self.growth, floor) + 1e-12,
                torch.maximum(dd * self.growth, floor) + 1e-12, floor)

    def deltas(self, state):
        return state[0], state[1]

    def give_up(self, state):
        return state[0] > self.max_delta


class FriedlanderOrban:
    """Friedlander-Orban scheme: both shifts start at `initial`, DECAY by
    10x at every new step down to `minimum`, and grow 100x on failure."""

    def __init__(self, initial: float = 1.0, minimum: float = 1e-10,
                 increase: float = 100.0, decrease: float = 0.1,
                 max_delta: float = 1e12):
        self.initial, self.minimum = initial, minimum
        self.increase, self.decrease = increase, decrease
        self.max_delta = max_delta

    def init_state(self, dtype, device="cpu"):
        z = _zero(dtype, device)
        # pre-divided by the decrease factor so the first new_step lands
        # exactly on `initial` (FriedlanderOrbanRegularization.cpp:21)
        v = self.initial / self.decrease
        return (z + v, z + v, z)

    def new_step(self, state):
        dp, dd, aux = state
        return (torch.clamp(dp * self.decrease, min=self.minimum),
                torch.clamp(dd * self.decrease, min=self.minimum), aux)

    def on_failure(self, state, mu, attempt):
        dp, dd, aux = state
        return (dp * self.increase, dd * self.increase, aux)

    def deltas(self, state):
        return state[0], state[1]

    def give_up(self, state):
        return state[0] > self.max_delta


class Ipopt:
    """Ipopt-style escalation: no shift while factorizations succeed; on the
    first failure of a new matrix the dual shift is mu^0.25 and the primal
    shift restarts at `initial` (first ever) or last_success/3; further
    failures multiply by 100 (no prior success) / 8.  aux carries the last
    successful primal shift."""

    barrier_exponent_dual = 0.25
    initial = 1e-4
    decrease = 1.0 / 3.0
    increase_initial = 100.0
    increase = 8.0
    minimum = 1e-20
    maximum = 1e40

    def init_state(self, dtype, device="cpu"):
        z = _zero(dtype, device)
        return (z, z, z)   # aux = primal_regularization_last

    def new_step(self, state):
        dp, dd, aux = state
        # remember the shift that produced the accepted factorization and
        # drop back to zero regularization for the fresh matrix
        z = torch.zeros_like(dp)
        return (z, z, torch.where(dp > 0.0, dp, aux))

    def on_failure(self, state, mu, attempt):
        dp, dd, aux = state
        first = torch.as_tensor(attempt == 0, device=dp.device)
        mu = torch.as_tensor(mu, dtype=dp.dtype, device=dp.device)
        never_succeeded = aux == 0.0
        dp_first = torch.where(never_succeeded, self.initial,
                               torch.clamp(self.decrease * aux,
                                           min=self.minimum))
        dp_nth = dp * torch.where(never_succeeded, self.increase_initial,
                                  self.increase)
        return (torch.where(first, dp_first, dp_nth),
                torch.where(first, mu ** self.barrier_exponent_dual, dd),
                aux)

    def deltas(self, state):
        return state[0], state[1]

    def give_up(self, state):
        return state[0] > self.maximum


def make_regularization(opts):
    """Strategy factory from Options (defaults preserve the ladder)."""
    kind = opts.regularization_strategy
    if kind == "ladder":
        return GrowthLadder(opts.primal_regularization,
                            opts.dual_regularization,
                            opts.regularization_growth)
    if kind == "friedlander_orban":
        return FriedlanderOrban()
    if kind == "ipopt":
        return Ipopt()
    raise ValueError(f"unknown regularization strategy {kind!r}")
