"""Selection strategies behind the registry (DESIGN.md §2).

The four paper strategies (Sec. IV-A3 baselines + the method):

  random-centralized    server picks K_t users uniformly (classic FedAvg)
  random-distributed    equal CW for everyone; CSMA decides
  priority-centralized  server picks top-K_t by Eq. 2 priority
  priority-distributed  THE PAPER'S METHOD: W = N / priority, counter
                        refrain, CSMA contention, first-K_t merge

plus two registry-proving extensions from the related literature:

  hetero-topk       heterogeneity-aware centralized top-K: Eq. 2 priority
                    scaled by each user's label-distribution divergence
                    (after "Data Heterogeneity-Aware Client Selection for
                    Federated Learning in Wireless Networks")
  adaptive-biased   adaptive-biased CW scheduling: the Eq. 3 window is
                    additionally biased by each user's selection deficit,
                    so under-served users contend harder (after "Adaptive
                    Biased User Scheduling for Heterogeneous Wireless
                    Federated Learning Network")

Every strategy declares capability flags instead of being special-cased
by name:

  uses_priority           the round must compute Eq. 2 priorities
  trains_before_selection selection happens BEFORE local training and
                          only winners train (true FedAvg); otherwise
                          all users train first (paper Steps 2-3)
  distributed             winners emerge from medium contention (carries
                          collision/airtime stats in its result)
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.csma import CSMAConfig, CSMASimulator
from repro_torch.engine.registry import register_strategy
from repro_torch.engine.types import SelectionContext, SelectionResult

#: the four selection schemes evaluated in the paper, in figure order
PAPER_STRATEGIES = ("random-centralized", "random-distributed",
                    "priority-centralized", "priority-distributed")


def sanitize_priorities(priorities) -> np.ndarray:
    """NaN-priority hole fix: map NaN scores to 0.0 (with a warning).

    A NaN priority used to poison selection two ways: in the batched
    centralized top-K, ``np.where(part, -prios, np.inf)`` sorts a NaN
    *behind* the +inf non-participants, so a refrained user could be
    crowned; in the distributed path ``cw_base / priority`` turned the
    NaN into a NaN contention window. Zero is the conservative reading
    — a model whose Eq. 2 distance is undefined has shown no usable
    progress, so it gets the lowest rank / the widest window.
    """
    p = np.asarray(priorities, np.float64)
    nan = np.isnan(p)
    if nan.any():
        warnings.warn(
            f"{int(nan.sum())} NaN priorities sanitized to 0.0 "
            "(diverged local model?)", RuntimeWarning, stacklevel=2)
        p = np.where(nan, 0.0, p)
    return p


def _assert_selected_participating(winners, participating, where: str):
    """Selection invariant: a refrained (Step 4) user never uploads."""
    bad = [int(u) for u in winners if not participating[int(u)]]
    assert not bad, (f"{where}: selected non-participating users {bad} "
                     f"(refrain mask violated)")


class Strategy:
    """Base strategy: capability flags + the ``select`` contract."""
    name: str = "?"
    uses_priority: bool = False
    distributed: bool = False
    trains_before_selection: bool = False

    def __init__(self, csma_config: Optional[CSMAConfig] = None,
                 seed: int = 0, contention_backend: str = "numpy"):
        # centralized strategies need no medium
        del csma_config, seed, contention_backend

    def select(self, ctx: SelectionContext) -> SelectionResult:
        raise NotImplementedError

    @classmethod
    def select_batch(cls, strategies: Sequence["Strategy"],
                     ctxs: Sequence[SelectionContext]
                     ) -> List[SelectionResult]:
        """Selection across E sweep lanes in one call (DESIGN.md §5).

        ``strategies[e]`` is lane e's OWN instance (its rng / simulator
        state must advance exactly as a sequential run would — that is
        the sweep's bit-parity contract), ``ctxs[e]`` its round context.
        The default is the per-lane loop, correct for every strategy;
        subclasses override to vectorize the cross-lane math while
        consuming each lane's streams in the same per-lane order.
        """
        return [s.select(c) for s, c in zip(strategies, ctxs)]


@register_strategy("random-centralized")
class RandomCentralized(Strategy):
    """Uniform server-side pick; only the chosen K_t train (FedAvg)."""
    trains_before_selection = True

    def select(self, ctx):
        cand = np.where(ctx.participating)[0]
        k = min(ctx.k_target, len(cand))
        return SelectionResult(
            winners=[int(u) for u in
                     ctx.rng.choice(cand, size=k, replace=False)])


@register_strategy("priority-centralized")
class PriorityCentralized(Strategy):
    """Top-K_t by Eq. 2 priority — the paper's centralized upper bound."""
    uses_priority = True

    def select(self, ctx):
        prios = sanitize_priorities(ctx.priorities)
        cand = np.where(ctx.participating)[0]
        k = min(ctx.k_target, len(cand))
        order = cand[np.argsort(-prios[cand], kind="stable")]
        winners = [int(u) for u in order[:k]]
        _assert_selected_participating(winners, ctx.participating,
                                       f"{self.name}.select")
        return SelectionResult(winners=winners)

    @classmethod
    def select_batch(cls, strategies, ctxs):
        """One (E, U) stable argsort for all lanes.

        Non-participants are scored +inf so they sort strictly last
        (priorities are NaN-sanitized first — an unsanitized NaN would
        sort behind the +inf sentinels and crown a refrained user);
        among participants a full-row stable sort keeps the same
        index order on priority ties as the scalar path's
        candidate-subset sort (candidates are index-ordered), so the
        winner lists match element-for-element.
        """
        if len({len(c.priorities) for c in ctxs}) != 1:
            return [s.select(c) for s, c in zip(strategies, ctxs)]
        prios = np.stack([sanitize_priorities(c.priorities)
                          for c in ctxs])
        part = np.stack([np.asarray(c.participating, bool) for c in ctxs])
        scores = np.where(part, -prios, np.inf)
        order = np.argsort(scores, axis=1, kind="stable")
        out = []
        for e, ctx in enumerate(ctxs):
            k = min(ctx.k_target, int(part[e].sum()))
            winners = [int(u) for u in order[e, :k]]
            _assert_selected_participating(
                winners, part[e], f"{cls.name}.select_batch[lane {e}]")
            out.append(SelectionResult(winners=winners))
        return out


class _DistributedCSMA(Strategy):
    """Shared CSMA plumbing: subclass supplies per-user CW sizes.

    ``contention_backend`` picks the medium engine: ``"numpy"`` (the
    bit-reproducible reference) or ``"device"`` (the JAX/Pallas event
    loop in ``repro_torch.kernels.contention``, distributionally validated —
    for dense-contention sweeps where the host loop is the bottleneck).
    """
    distributed = True

    def __init__(self, csma_config: Optional[CSMAConfig] = None,
                 seed: int = 0, contention_backend: str = "numpy"):
        self._sim = CSMASimulator(csma_config, seed=seed,
                                  backend=contention_backend)

    def _windows(self, ctx) -> np.ndarray:
        raise NotImplementedError

    def select(self, ctx):
        windows = self._windows(ctx)
        # Eq. 3: T_backoff = R * W with R ~ U(0,1), drawn by each user
        backoffs = ctx.rng.uniform(0.0, 1.0, size=len(windows)) * windows
        slot_s = self._sim.config.slot_us * 1e-6
        res = self._sim.contend(
            backoff_seconds=backoffs * slot_s,   # windows are in slot units
            windows_seconds=windows * slot_s,
            k_target=ctx.k_target,
            participating=ctx.participating)
        return SelectionResult(winners=res.winners,
                               collisions=res.collisions,
                               elapsed_slots=res.elapsed_slots,
                               finish_slots=res.finish_slots)

    @classmethod
    def select_batch(cls, strategies, ctxs):
        """All E lanes' contention in one numpy pass per medium event.

        Per lane: the Eq. 3 CW vector and the R ~ U(0,1) draws come
        from the lane's own ``_windows`` / context rng (same order as
        ``select``), then ONE ``contend_batch`` call advances every
        lane's medium together, redrawing collisions from each lane's
        own persistent simulator rng — so lane e's winner sequence is
        bit-identical to a sequential run of that lane (the contract
        tests/test_sweep.py pins). Device-backed lanes route the whole
        batch through ONE ``device_contend_batch`` program instead
        (collision redraws from per-row threefry streams; parity is
        distributional by contract). Falls back to the per-lane loop
        when the lanes' CSMA configs, contention backends or user
        counts differ (a batch shares one slot/airtime clock).
        """
        lead = strategies[0]._sim
        cfg = lead.config
        if (any(s._sim.config != cfg or s._sim.backend != lead.backend
                for s in strategies)
                or len({len(c.priorities) for c in ctxs}) != 1):
            return [s.select(c) for s, c in zip(strategies, ctxs)]
        windows = np.stack([s._windows(c)
                            for s, c in zip(strategies, ctxs)])
        backoffs = np.stack(
            [c.rng.uniform(0.0, 1.0, size=windows.shape[1])
             for c in ctxs]) * windows
        slot_s = cfg.slot_us * 1e-6
        part = np.stack([np.asarray(c.participating, bool) for c in ctxs])
        # device lanes: one fused device program, redraw streams derived
        # inside from the leader sim's (entropy, call) counter per row;
        # numpy lanes: each row consumes its own persistent generator
        rng_kw = ({} if lead.backend == "device"
                  else {"rngs": [s._sim._rng for s in strategies]})
        batch = lead.contend_batch(
            backoffs * slot_s, windows * slot_s,
            k_target=np.array([c.k_target for c in ctxs], np.int64),
            participating=part, **rng_kw)
        out = []
        for e in range(len(ctxs)):
            r = batch.round_result(e)
            out.append(SelectionResult(winners=r.winners,
                                       collisions=r.collisions,
                                       elapsed_slots=r.elapsed_slots,
                                       finish_slots=r.finish_slots))
        return out


@register_strategy("random-distributed")
class RandomDistributed(_DistributedCSMA):
    """Equal CW for everyone; the medium alone picks (FL-over-WiFi)."""

    def _windows(self, ctx):
        return np.full(len(ctx.priorities), ctx.cw_base)


@register_strategy("priority-distributed")
class PriorityDistributed(_DistributedCSMA):
    """The paper's method: W_k = N / priority_k (Eq. 3)."""
    uses_priority = True

    def _windows(self, ctx):
        # sanitize first: np.maximum(NaN, eps) propagates the NaN into
        # the CW size (NaN backoffs -> quantization garbage)
        prios = sanitize_priorities(ctx.priorities)
        return ctx.cw_base / np.maximum(prios, 1e-9)


@register_strategy("hetero-topk")
class HeterogeneityTopK(Strategy):
    """Centralized top-K by priority x (1 + gamma * heterogeneity).

    ``heterogeneity`` is a per-user data-divergence score in [0, 1]
    (total-variation distance between the user's label distribution and
    the population's — supplied by the backend via the context). Users
    whose data deviates most from the population are boosted, on top of
    the Eq. 2 model-distance signal. With no heterogeneity info this
    degrades gracefully to priority-centralized.
    """
    uses_priority = True

    def __init__(self, csma_config=None, seed: int = 0,
                 contention_backend: str = "numpy", gamma: float = 1.0):
        super().__init__(csma_config, seed, contention_backend)
        self.gamma = float(gamma)

    def select(self, ctx):
        het = getattr(ctx, "heterogeneity", None)
        scores = sanitize_priorities(ctx.priorities)
        if het is not None:
            scores = scores * (1.0 + self.gamma * np.asarray(het, np.float64))
        cand = np.where(ctx.participating)[0]
        k = min(ctx.k_target, len(cand))
        order = cand[np.argsort(-scores[cand], kind="stable")]
        winners = [int(u) for u in order[:k]]
        _assert_selected_participating(winners, ctx.participating,
                                       f"{self.name}.select")
        return SelectionResult(winners=winners)


@register_strategy("channel-distributed")
class ChannelDistributed(_DistributedCSMA):
    """Eq. 3 CW scheduling with the link quality folded into Eq. 2.

    A user on a deep-faded link is a poor upload candidate even with a
    large model-distance: its packet is likely lost (PER-gated merge)
    and its airtime is long. Each user scales its own priority by a
    normalized SNR-quality factor ``q = sigmoid((snr - thr) / width)``
    raised to ``beta`` before applying Eq. 3 — W_k = N / (prio_k *
    q_k^beta) — so good links contend harder. ``q`` is exactly the
    channel layer's packet-delivery probability under the waterfall PER
    model, i.e. the window shrinks with the link's delivery odds. Every
    factor is locally measurable (own SNR, own model delta), so the
    scheme stays distributed. Without a channel layer (``ctx.snr_db``
    is None) this degrades to priority-distributed exactly.
    """
    uses_priority = True

    def __init__(self, csma_config=None, seed: int = 0,
                 contention_backend: str = "numpy", beta: float = 1.0,
                 snr_threshold_db: float = 5.0, snr_width_db: float = 2.0):
        super().__init__(csma_config, seed, contention_backend)
        self.beta = float(beta)
        self.snr_threshold_db = float(snr_threshold_db)
        self.snr_width_db = float(snr_width_db)

    def _windows(self, ctx):
        prio = np.maximum(sanitize_priorities(ctx.priorities), 1e-9)
        snr = getattr(ctx, "snr_db", None)
        if snr is None:
            return ctx.cw_base / prio
        z = (np.asarray(snr, np.float64) - self.snr_threshold_db) \
            / max(self.snr_width_db, 1e-9)
        quality = 1.0 / (1.0 + np.exp(-np.clip(z, -60.0, 60.0)))
        return ctx.cw_base / (prio * np.maximum(quality, 1e-9) ** self.beta)


@register_strategy("adaptive-biased")
class AdaptiveBiasedCW(_DistributedCSMA):
    """Distributed CW scheduling with an adaptive fairness bias.

    Each user's Eq. 3 window is divided by ``exp(eta * deficit)`` where
    ``deficit = 1/K - share_so_far`` (its fair upload share minus its
    realized share, from the fairness-counter values the engine already
    tracks). Under-served users get smaller windows and contend harder;
    over-served users back off — a *soft*, self-tuning version of the
    paper's hard counter-refrain, and each user can compute its own bias
    locally, so the scheme stays distributed.
    """
    uses_priority = True

    def __init__(self, csma_config=None, seed: int = 0,
                 contention_backend: str = "numpy", eta: float = 4.0):
        super().__init__(csma_config, seed, contention_backend)
        self.eta = float(eta)

    def _windows(self, ctx):
        prio = np.maximum(sanitize_priorities(ctx.priorities), 1e-9)
        shares = getattr(ctx, "counter_values", None)
        if shares is None:
            bias = np.ones_like(prio)
        else:
            deficit = 1.0 / len(prio) - np.asarray(shares, np.float64)
            bias = np.exp(self.eta * deficit)
        return ctx.cw_base / (prio * bias)
