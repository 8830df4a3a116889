"""Datacenter topologies for the deployment planner (paper §7.5, Table 6).

Fat-Tree [4], DCell [30], BCube [29], Jellyfish [53] — the four families the
paper evaluates the optimizer on.  Each builder returns a ``Network``: nodes
(hosts + switches, with per-switch programmability flags), adjacency, and
path utilities (BFS shortest path + a Yen-style k-shortest-paths for the
planner's candidate path set P).

Copied unchanged from ``src/repro/core/topology.py`` of the JAX package
(numpy only; the port imports nothing from ``repro``).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np

__all__ = ["Network", "fat_tree", "dcell", "bcube", "jellyfish"]


@dataclasses.dataclass
class Network:
    name: str
    nodes: list[str]
    kind: dict[str, str]              # node -> "host" | "switch"
    adj: dict[str, list[str]]
    programmable: dict[str, bool]

    @property
    def n_switches(self) -> int:
        return sum(1 for n in self.nodes if self.kind[n] == "switch")

    @property
    def n_hosts(self) -> int:
        return sum(1 for n in self.nodes if self.kind[n] == "host")

    def hosts(self) -> list[str]:
        return [n for n in self.nodes if self.kind[n] == "host"]

    def switches(self) -> list[str]:
        return [n for n in self.nodes if self.kind[n] == "switch"]

    def without(self, failed: set[str]) -> "Network":
        """The surviving topology after ``failed`` nodes die (the control
        plane's replan view).  Path search on the subgraph reports
        unreachable endpoints honestly — ``shortest_path`` returns ``None``
        and ``k_shortest_paths`` returns ``[]`` — instead of routing through
        dead hardware."""
        failed = set(failed)
        unknown = failed - set(self.kind)
        if unknown:
            raise ValueError(f"unknown node(s): {sorted(unknown)}")
        nodes = [n for n in self.nodes if n not in failed]
        return Network(
            self.name,
            nodes,
            {n: self.kind[n] for n in nodes},
            {n: [v for v in self.adj[n] if v not in failed] for n in nodes},
            {n: self.programmable[n] for n in nodes},
        )

    # ---------------------------------------------------------------- paths
    def shortest_path(self, src: str, dst: str) -> list[str] | None:
        prev: dict[str, str] = {src: src}
        q = [src]
        while q:
            nxt = []
            for u in q:
                if u == dst:
                    path = [u]
                    while path[-1] != src:
                        path.append(prev[path[-1]])
                    return path[::-1]
                for v in self.adj[u]:
                    if v not in prev:
                        prev[v] = u
                        nxt.append(v)
            q = nxt
        return None

    def k_shortest_paths(self, src: str, dst: str, k: int = 4) -> list[list[str]]:
        """Yen's algorithm (hop metric). Returns up to k loop-free paths,
        shortest first — the planner's candidate set P."""
        first = self.shortest_path(src, dst)
        if first is None:
            return []
        paths = [first]
        candidates: list[tuple[int, int, list[str]]] = []
        tiebreak = itertools.count()
        while len(paths) < k:
            prev_path = paths[-1]
            for i in range(len(prev_path) - 1):
                spur, root = prev_path[i], prev_path[: i + 1]
                removed: set[tuple[str, str]] = set()
                for p in paths:
                    if p[: i + 1] == root and len(p) > i + 1:
                        removed.add((p[i], p[i + 1]))
                banned_nodes = set(root[:-1])
                tail = self._sp_avoid(spur, dst, removed, banned_nodes)
                if tail is not None:
                    cand = root[:-1] + tail
                    if cand not in paths and all(c[2] != cand for c in candidates):
                        heapq.heappush(candidates, (len(cand), next(tiebreak), cand))
            if not candidates:
                break
            _, _, best = heapq.heappop(candidates)
            paths.append(best)
        return paths

    def _sp_avoid(self, src, dst, removed_edges, banned_nodes):
        prev = {src: src}
        q = [src]
        while q:
            nxt = []
            for u in q:
                if u == dst:
                    path = [u]
                    while path[-1] != src:
                        path.append(prev[path[-1]])
                    return path[::-1]
                for v in self.adj[u]:
                    if v in banned_nodes or v in prev or (u, v) in removed_edges:
                        continue
                    prev[v] = u
                    nxt.append(v)
            q = nxt
        return None


def _mk(name: str) -> tuple[list, dict, dict, dict]:
    return [], {}, {}, {}


def _add(nodes, kind, adj, prog, node, nkind, programmable=True):
    if node not in kind:
        nodes.append(node)
        kind[node] = nkind
        adj[node] = []
        prog[node] = programmable and nkind == "switch"


def _link(adj, a, b):
    if b not in adj[a]:
        adj[a].append(b)
        adj[b].append(a)


# --------------------------------------------------------------------------
def fat_tree(k: int, *, hosts_per_edge: int = 1) -> Network:
    """K-ary fat-tree: k pods, k^2/4 core, k/2 agg + k/2 edge per pod."""
    if k % 2:
        raise ValueError("fat-tree k must be even")
    nodes, kind, adj, prog = _mk("fat-tree")
    half = k // 2
    cores = [f"core{i}" for i in range(half * half)]
    for c in cores:
        _add(nodes, kind, adj, prog, c, "switch")
    for p in range(k):
        aggs = [f"agg{p}_{i}" for i in range(half)]
        edges = [f"edge{p}_{i}" for i in range(half)]
        for a in aggs:
            _add(nodes, kind, adj, prog, a, "switch")
        for e in edges:
            _add(nodes, kind, adj, prog, e, "switch")
        for a in aggs:
            for e in edges:
                _link(adj, a, e)
        for i, a in enumerate(aggs):
            for j in range(half):
                _link(adj, a, cores[i * half + j])
        for ei, e in enumerate(edges):
            for h in range(hosts_per_edge):
                hn = f"h{p}_{ei}_{h}"
                _add(nodes, kind, adj, prog, hn, "host")
                _link(adj, e, hn)
    return Network("fat-tree", nodes, kind, adj, prog)


def dcell(n: int, k: int) -> Network:
    """DCell_k with n servers per DCell_0 (recursive, Guo et al. 2008)."""
    nodes, kind, adj, prog = _mk("dcell")

    def t(level):  # servers in a DCell_level
        cnt = n
        for _ in range(level):
            cnt = cnt * (cnt + 1)
        return cnt

    def build(prefix: tuple, level: int) -> list[str]:
        if level == 0:
            sw = "sw" + "_".join(map(str, prefix))
            _add(nodes, kind, adj, prog, sw, "switch")
            servers = []
            for i in range(n):
                s = "s" + "_".join(map(str, prefix + (i,)))
                _add(nodes, kind, adj, prog, s, "host")
                _link(adj, sw, s)
                servers.append(s)
            return servers
        g = t(level - 1) + 1           # number of sub-cells
        subs = [build(prefix + (i,), level - 1) for i in range(g)]
        # Full mesh between sub-cells: connect server j of cell i to server i
        # of cell j+1 (standard DCell wiring).
        for i in range(g):
            for j in range(i + 1, g):
                a = subs[i][j - 1 if j > i else j]
                b = subs[j][i]
                _link(adj, a, b)
        return [s for sub in subs for s in sub]

    build((), k)
    return Network("dcell", nodes, kind, adj, prog)


def bcube(n: int, k: int) -> Network:
    """BCube_k with n-port switches: n^(k+1) servers, (k+1)*n^k switches."""
    nodes, kind, adj, prog = _mk("bcube")
    n_servers = n ** (k + 1)
    servers = []
    for i in range(n_servers):
        digits = []
        x = i
        for _ in range(k + 1):
            digits.append(x % n)
            x //= n
        s = "s" + "_".join(map(str, digits[::-1]))
        _add(nodes, kind, adj, prog, s, "host")
        servers.append((s, digits[::-1]))
    for level in range(k + 1):
        for sw_idx in range(n**k):
            sw = f"sw{level}_{sw_idx}"
            _add(nodes, kind, adj, prog, sw, "switch")
    for s, digits in servers:
        for level in range(k + 1):
            rest = [d for i, d in enumerate(digits) if i != (k - level)]
            sw_idx = 0
            for d in rest:
                sw_idx = sw_idx * n + d
            _link(adj, s, f"sw{level}_{sw_idx}")
    return Network("bcube", nodes, kind, adj, prog)


def jellyfish(n: int, d: int, *, hosts: int = 8, seed: int = 0) -> Network:
    """Random d-regular graph over n switches (Singla et al., NSDI'12)."""
    rng = np.random.default_rng(seed)
    nodes, kind, adj, prog = _mk("jellyfish")
    sws = [f"sw{i}" for i in range(n)]
    for s in sws:
        _add(nodes, kind, adj, prog, s, "switch")
    # Pairing-model regular graph with patching.
    stubs = [i for i in range(n) for _ in range(d)]
    for attempt in range(200):
        rng.shuffle(stubs)
        pairs = [(stubs[2 * i], stubs[2 * i + 1]) for i in range(len(stubs) // 2)]
        ok = all(a != b for a, b in pairs)
        edge_set = {tuple(sorted(p)) for p in pairs}
        if ok and len(edge_set) == len(pairs):
            for a, b in pairs:
                _link(adj, sws[a], sws[b])
            break
    else:  # fallback: ring + chords
        for i in range(n):
            _link(adj, sws[i], sws[(i + 1) % n])
            for c in range(2, d):
                _link(adj, sws[i], sws[(i + 1 + c * (n // d)) % n])
    for h in range(hosts):
        hn = f"h{h}"
        _add(nodes, kind, adj, prog, hn, "host")
        _link(adj, hn, sws[int(rng.integers(0, n))])
    return Network("jellyfish", nodes, kind, adj, prog)
