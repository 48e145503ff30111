"""PC causal discovery with Fisher-z and chi-square independence tests
(port of ``cdgvae_tpu/utils/pc.py:21-361``, numpy).

PC-stable with v-structure orientation and Meek rules R1-R4, returning the
CPDAG in causallearn's adjacency encoding, as the reference's custom SHD
reads it:

    graph[i, j] = -1 and graph[j, i] =  1   for a directed edge i -> j
    graph[i, j] = -1 and graph[j, i] = -1   for an undirected edge i - j
    graph[i, j] =  0                        for no edge
"""
from __future__ import annotations

from itertools import combinations

import numpy as np


def fisher_z_pvalue(corr: np.ndarray, n: int, i: int, j: int,
                    cond: tuple) -> float:
    """Fisher-z test of partial correlation rho(i, j | cond). scipy is
    imported here, so that importing the port needs none."""
    from scipy.stats import norm

    idx = [i, j, *cond]
    sub = corr[np.ix_(idx, idx)]
    try:
        prec = np.linalg.inv(sub)
    except np.linalg.LinAlgError:
        prec = np.linalg.pinv(sub)
    r = -prec[0, 1] / np.sqrt(prec[0, 0] * prec[1, 1])
    r = np.clip(r, -0.9999999, 0.9999999)
    z = 0.5 * np.log((1 + r) / (1 - r))
    stat = np.sqrt(max(n - len(cond) - 3, 1)) * abs(z)
    return 2.0 * (1.0 - norm.cdf(stat))


def chisq_pvalue(data: np.ndarray, i: int, j: int, cond: tuple) -> float:
    """Chi-square test of independence of columns i, j given cond, by
    stratifying on the conditioning columns' value combinations (the
    'chisq' test the reference uses for the loan and adult real-data
    CPDAGs). Columns are treated as categorical."""
    from scipy.stats import chi2

    if cond:
        _, strata = np.unique(data[:, list(cond)], axis=0,
                              return_inverse=True)
    else:
        strata = np.zeros(len(data), dtype=int)
    stat, dof = 0.0, 0
    for s in np.unique(strata):
        sub = data[strata == s]
        xi, xj = sub[:, i], sub[:, j]
        ri, ci = np.unique(xi, return_inverse=True)
        rj, cj = np.unique(xj, return_inverse=True)
        if len(ri) < 2 or len(rj) < 2:
            continue
        table = np.zeros((len(ri), len(rj)))
        np.add.at(table, (ci, cj), 1.0)
        rows = table.sum(1, keepdims=True)
        cols = table.sum(0, keepdims=True)
        expect = rows * cols / table.sum()
        mask = expect > 0
        stat += float(((table - expect) ** 2 / np.where(mask, expect, 1.0)
                       )[mask].sum())
        dof += (len(ri) - 1) * (len(rj) - 1)
    if dof == 0:
        return 1.0
    return float(1.0 - chi2.cdf(stat, dof))


def pc(data: np.ndarray, alpha: float = 0.05, max_cond: int | None = None,
       indep_test="fisherz", num_vars: int | None = None):
    """PC-stable. ``indep_test``: 'fisherz' (continuous, partial
    correlation), 'chisq' (categorical), or a callable
    ``(i, j, cond) -> pvalue`` (e.g. a d-separation oracle for
    correctness validation — pass ``num_vars`` and ``data=None`` then).
    Returns (graph, sepsets) where graph is the CPDAG in causallearn
    encoding."""
    if callable(indep_test):
        if num_vars is None:
            if data is None:
                raise ValueError("callable indep_test needs num_vars or data")
            num_vars = np.asarray(data).shape[1]
        d = num_vars
        ci_pvalue = indep_test
    else:
        data = np.asarray(data, dtype=np.float64)
        n, d = data.shape
        # guard constant columns
        std = data.std(axis=0)
        zdata = (data - data.mean(axis=0)) / np.where(std == 0, 1.0, std)
        corr = np.corrcoef(zdata, rowvar=False)
        corr = np.nan_to_num(corr, nan=0.0)
        np.fill_diagonal(corr, 1.0)

        if indep_test == "fisherz":
            def ci_pvalue(i, j, cond):
                return fisher_z_pvalue(corr, n, i, j, cond)
        elif indep_test == "chisq":
            def ci_pvalue(i, j, cond):
                return chisq_pvalue(data, i, j, cond)
        else:
            raise ValueError(f"unknown indep_test {indep_test}")

    adj = np.ones((d, d), dtype=bool)
    np.fill_diagonal(adj, False)
    sepset = {}
    max_cond = d - 2 if max_cond is None else max_cond

    level = 0
    while level <= max_cond:
        any_tested = False
        adj_frozen = adj.copy()  # PC-stable: neighbor sets fixed per level
        for i in range(d):
            for j in range(i + 1, d):
                if not adj[i, j]:
                    continue
                # the PC algorithm conditions on subsets of adj(i)\{j}
                # AND adj(j)\{i} — testing only one side misses edges
                # whose separating set lives in the other endpoint's
                # neighborhood (e.g. a collider's parents)
                removed = False
                for a, b in ((i, j), (j, i)):
                    neighbors = [k for k in range(d)
                                 if adj_frozen[a, k] and k != b]
                    if len(neighbors) < level:
                        continue
                    for cond in combinations(neighbors, level):
                        any_tested = True
                        if ci_pvalue(i, j, cond) > alpha:
                            adj[i, j] = adj[j, i] = False
                            sepset[(i, j)] = sepset[(j, i)] = set(cond)
                            removed = True
                            break
                    if removed:
                        break
        if not any_tested:
            break
        level += 1

    # skeleton -> partially directed graph
    # directed[i, j] == True means i -> j
    directed = np.zeros((d, d), dtype=bool)
    undirected = adj.copy()

    # v-structures: i - k - j, i !~ j, k not in sepset(i, j) => i -> k <- j
    for k in range(d):
        nbrs = [x for x in range(d) if adj[x, k]]
        for i, j in combinations(nbrs, 2):
            if adj[i, j]:
                continue
            if k not in sepset.get((i, j), set()):
                if undirected[i, k]:
                    directed[i, k] = True
                    undirected[i, k] = undirected[k, i] = False
                if undirected[j, k]:
                    directed[j, k] = True
                    undirected[j, k] = undirected[k, j] = False

    # Meek rules until fixpoint
    changed = True
    while changed:
        changed = False
        for i in range(d):
            for j in range(d):
                if not undirected[i, j]:
                    continue
                # R1: k -> i, k !~ j  =>  i -> j
                if any(directed[k, i] and not adj[k, j] and k != j
                       for k in range(d)):
                    directed[i, j] = True
                    undirected[i, j] = undirected[j, i] = False
                    changed = True
                    continue
                # R2: i -> k -> j  =>  i -> j
                if any(directed[i, k] and directed[k, j] for k in range(d)):
                    directed[i, j] = True
                    undirected[i, j] = undirected[j, i] = False
                    changed = True
                    continue
                # R3: i - k1 -> j, i - k2 -> j, k1 !~ k2  =>  i -> j
                ks = [k for k in range(d)
                      if undirected[i, k] and directed[k, j]]
                if any(not adj[k1, k2] for k1, k2 in combinations(ks, 2)):
                    directed[i, j] = True
                    undirected[i, j] = undirected[j, i] = False
                    changed = True
                    continue
                # R4: i - k1, k1 -> k2, k2 -> j, k1 !~ j => i -> j
                for k1 in range(d):
                    if not (undirected[i, k1] or adj[i, k1]):
                        continue
                    if any(directed[k1, k2] and directed[k2, j]
                           and not adj[k1, j] for k2 in range(d)):
                        directed[i, j] = True
                        undirected[i, j] = undirected[j, i] = False
                        changed = True
                        break

    graph = np.zeros((d, d), dtype=int)
    for i in range(d):
        for j in range(d):
            if directed[i, j]:
                graph[i, j] = -1
                graph[j, i] = 1
            elif undirected[i, j]:
                graph[i, j] = -1
    return graph, sepset


def d_separated(dag: np.ndarray, i: int, j: int, cond) -> bool:
    """Exact d-separation test on a known DAG via ancestral moralization
    (Lauritzen): restrict to the ancestral set of {i, j} ∪ cond, moralize
    (undirect all edges + marry co-parents), delete cond, and check whether
    i and j are still connected. A graphical oracle to validate PC with."""
    dag = np.asarray(dag, dtype=bool)
    d = dag.shape[0]
    cond = set(cond)

    # ancestral closure of {i, j} | cond
    anc = {i, j} | cond
    frontier = list(anc)
    while frontier:
        node = frontier.pop()
        for p in range(d):
            if dag[p, node] and p not in anc:
                anc.add(p)
                frontier.append(p)

    # moralize the induced subgraph
    moral = np.zeros((d, d), dtype=bool)
    anc_list = sorted(anc)
    for a in anc_list:
        for b in anc_list:
            if dag[a, b]:
                moral[a, b] = moral[b, a] = True
    for child in anc_list:
        parents = [p for p in anc_list if dag[p, child]]
        for p1, p2 in combinations(parents, 2):
            moral[p1, p2] = moral[p2, p1] = True

    # BFS from i to j avoiding cond
    if i in cond or j in cond:
        raise ValueError("endpoints cannot be in the conditioning set")
    seen = {i}
    frontier = [i]
    while frontier:
        node = frontier.pop()
        for nxt in range(d):
            if moral[node, nxt] and nxt not in seen and nxt not in cond:
                if nxt == j:
                    return False
                seen.add(nxt)
                frontier.append(nxt)
    return True


def oracle_ci_test(dag: np.ndarray):
    """Wrap a true DAG as a PC-compatible CI test: p-value 1.0 when the
    pair is d-separated given cond (independent), 0.0 otherwise."""
    def ci(i, j, cond):
        return 1.0 if d_separated(dag, i, j, cond) else 0.0
    return ci


def dag_to_cpdag(dag: np.ndarray) -> np.ndarray:
    """True CPDAG of a DAG via Chickering (1995)'s compelled-edge labeling.

    Deliberately a DIFFERENT algorithm from the skeleton + v-structure +
    Meek closure used inside :func:`pc`, so the two can cross-validate:
    edges are visited in a topological total order and labeled
    compelled/reversible by the parent-set comparison rules. Returns the
    CPDAG in causallearn encoding (see module docstring)."""
    dag = np.asarray(dag, dtype=bool)
    d = dag.shape[0]

    # topological order (Kahn)
    indeg = dag.sum(axis=0).astype(int)
    order, stack = [], [v for v in range(d) if indeg[v] == 0]
    while stack:
        v = stack.pop()
        order.append(v)
        for w in range(d):
            if dag[v, w]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    stack.append(w)
    if len(order) != d:
        raise ValueError("input graph is not a DAG")
    topo_pos = {v: k for k, v in enumerate(order)}

    # total order on edges: by topo position of head (y), then REVERSE topo
    # position of tail (x) — Chickering's "maximum edge ordering"
    edges = [(x, y) for x in range(d) for y in range(d) if dag[x, y]]
    edges.sort(key=lambda e: (topo_pos[e[1]], -topo_pos[e[0]]))

    UNKNOWN, COMPELLED, REVERSIBLE = 0, 1, 2
    label = {e: UNKNOWN for e in edges}

    for (x, y) in edges:
        if label[(x, y)] != UNKNOWN:
            continue
        done = False
        # rule: for every w -> x labeled COMPELLED
        for w in range(d):
            if dag[w, x] and label.get((w, x)) == COMPELLED:
                if not dag[w, y]:
                    # w is a parent of x but not of y: x -> y and every
                    # edge into y becomes compelled
                    for p in range(d):
                        if dag[p, y]:
                            label[(p, y)] = COMPELLED
                    done = True
                    break
                else:
                    label[(w, y)] = COMPELLED
        if done:
            continue
        # if there exists z -> y with z != x and z not a parent of x:
        # x -> y (and all edges into y) compelled; else all reversible
        exists_z = any(dag[z, y] and z != x and not dag[z, x]
                       for z in range(d))
        for p in range(d):
            if dag[p, y] and label[(p, y)] == UNKNOWN:
                label[(p, y)] = COMPELLED if exists_z else REVERSIBLE

    graph = np.zeros((d, d), dtype=int)
    for (x, y), lab in label.items():
        if lab == COMPELLED:
            graph[x, y] = -1
            graph[y, x] = 1
        else:
            graph[x, y] = graph[y, x] = -1
    return graph


def random_dag(rng: np.random.Generator, d: int,
               edge_prob: float) -> np.ndarray:
    """Random DAG on d nodes: sample a random permutation as the topological
    order and include each forward edge independently with edge_prob."""
    perm = rng.permutation(d)
    dag = np.zeros((d, d), dtype=bool)
    for a in range(d):
        for b in range(a + 1, d):
            if rng.random() < edge_prob:
                dag[perm[a], perm[b]] = True
    return dag


def cpdag_shd(G1: np.ndarray, G2: np.ndarray) -> int:
    """The reference's custom SHD between two CPDAGs in causallearn
    encoding: the upper-triangular mismatch count plus an orientation
    penalty on matching upper-triangular entries."""
    shd = int((np.triu(G1) != np.triu(G2)).sum())
    nonzero_idx = np.where(np.triu(G2) != 0)
    flag = np.triu(G1)[nonzero_idx] == np.triu(G2)[nonzero_idx]
    nonzero_idx = (nonzero_idx[1][flag], nonzero_idx[0][flag])
    shd += int((np.tril(G1)[nonzero_idx] != np.tril(G2)[nonzero_idx]).sum())
    return shd
