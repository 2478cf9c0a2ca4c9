"""Replication policy engine: team placement across failure domains.

Reference: fdbrpc/ReplicationPolicy.h:99-127 (PolicyOne / PolicyAcross /
PolicyAnd over locality attributes), fdbrpc/Locality.h (LocalityData:
processid/zoneid/machineid/dcid), fdbrpc/ReplicationUtils.cpp
(selectReplicas / validate). FDB's standard configurations are instances:
`triple` = Across(3, "zoneid", One()), `double` = Across(2, "zoneid", One()).

The engine answers two questions for the data distributor:
  validate(team)   — does this team satisfy the policy?
  select_replicas  — pick n candidates satisfying it (greedy over the
                     rarest attribute values first, the shape of the
                     reference's deep-first selection)
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class LocalityData:
    """fdbrpc/Locality.h LocalityData's standard keys."""

    process_id: str = ""
    zone_id: str = ""
    machine_id: str = ""
    dc_id: str = ""

    def get(self, attrib: str) -> str:
        return {"processid": self.process_id, "zoneid": self.zone_id,
                "machineid": self.machine_id, "dcid": self.dc_id}[attrib]


class Policy:
    def n_required(self) -> int:
        raise NotImplementedError

    def validate(self, localities: list[LocalityData]) -> bool:
        raise NotImplementedError


@dataclass(frozen=True)
class PolicyOne(Policy):
    """ReplicationPolicy.h PolicyOne: any single replica."""

    def n_required(self) -> int:
        return 1

    def validate(self, localities) -> bool:
        return len(localities) >= 1

    def __str__(self):
        return "One()"


@dataclass(frozen=True)
class PolicyAcross(Policy):
    """ReplicationPolicy.h:99 PolicyAcross(count, attrib, sub): `count`
    distinct values of `attrib`, each internally satisfying `sub`."""

    count: int
    attrib: str
    sub: Policy = field(default_factory=PolicyOne)

    def n_required(self) -> int:
        return self.count * self.sub.n_required()

    def validate(self, localities) -> bool:
        groups: dict[str, list[LocalityData]] = {}
        for loc in localities:
            groups.setdefault(loc.get(self.attrib), []).append(loc)
        ok = sum(1 for g in groups.values() if self.sub.validate(g))
        return ok >= self.count

    def __str__(self):
        return f"Across({self.count}, {self.attrib}, {self.sub})"


@dataclass(frozen=True)
class PolicyAnd(Policy):
    """ReplicationPolicy.h PolicyAnd: every sub-policy must hold."""

    subs: tuple

    def n_required(self) -> int:
        return max(s.n_required() for s in self.subs)

    def validate(self, localities) -> bool:
        return all(s.validate(localities) for s in self.subs)

    def __str__(self):
        return "And(" + ", ".join(str(s) for s in self.subs) + ")"


def select_replicas(policy: Policy,
                    candidates: list[tuple[str, LocalityData]],
                    already: list[tuple[str, LocalityData]] | None = None,
                    ) -> list[str] | None:
    """Pick addresses so that `already + picks` satisfies `policy`, using as
    few picks as possible; None when impossible (ReplicationUtils
    selectReplicas). Greedy: prefer candidates contributing a NEW value of
    the policy's discriminating attribute, rarest values first (keeps
    future choices open, like the reference's deep-first search)."""
    already = list(already or [])
    locs = [l for _a, l in already]
    if policy.validate(locs):
        return []
    picks: list[str] = []
    pool = [(i, a, l) for i, (a, l) in enumerate(candidates)
            if a not in {a2 for a2, _l in already}]
    for _ in range(policy.n_required() + len(already) + 1):
        best = None
        for idx, addr, loc in pool:
            trial = locs + [loc]
            # score: does this pick move validation forward for any Across?
            gain = _coverage(policy, trial) - _coverage(policy, locs)
            rarity = sum(1 for _i2, _a2, l2 in pool
                         if _discr_values(policy, l2) == _discr_values(policy, loc))
            # final tiebreak = INPUT ORDER: callers pass candidates ranked
            # (e.g. by ProcessClass fitness), and that ranking must survive
            # the policy selection
            cand = (-gain, rarity, idx)
            if gain > 0 and (best is None or cand < best[0]):
                best = (cand, addr, loc)
        if best is None:
            return None  # no candidate makes progress: impossible
        _, addr, loc = best
        picks.append(addr)
        locs.append(loc)
        pool = [c for c in pool if c[1] != addr]
        if policy.validate(locs):
            return picks
    return None


def _discr_values(policy: Policy, loc: LocalityData) -> tuple:
    if isinstance(policy, PolicyAcross):
        return (loc.get(policy.attrib),) + _discr_values(policy.sub, loc)
    if isinstance(policy, PolicyAnd):
        return tuple(v for s in policy.subs for v in _discr_values(s, loc))
    return ()


_BIG = 10**6


def _coverage(policy: Policy, localities: list[LocalityData]) -> int:
    """How 'satisfied' the policy is — strictly increases whenever a replica
    moves validation forward at any level (a full group outweighs any sum
    of partial ones, and only the best `count` groups score, so surplus
    replicas in an already-full group never mask missing groups)."""
    if isinstance(policy, PolicyAcross):
        groups: dict[str, list[LocalityData]] = {}
        for loc in localities:
            groups.setdefault(loc.get(policy.attrib), []).append(loc)
        scores = sorted(
            (_BIG if policy.sub.validate(g)
             else min(_coverage(policy.sub, g), _BIG - 1)
             for g in groups.values()),
            reverse=True)
        return sum(scores[:policy.count])
    if isinstance(policy, PolicyAnd):
        return sum(_coverage(s, localities) for s in policy.subs)
    return _BIG if localities else 0


def policy_for_replication(n_replicas: int) -> Policy:
    """FDB's standard configs: single/double/triple = Across(n, zoneid, One)."""
    if n_replicas <= 1:
        return PolicyOne()
    return PolicyAcross(n_replicas, "zoneid")
