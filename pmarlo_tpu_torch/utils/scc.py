"""Strongly-connected-component analysis on tiny state graphs.

Reference: src/pmarlo/utils/scc.py:69 (scipy csgraph). Here: iterative
Tarjan on NumPy adjacency — host-side by design (graphs have at most a few
hundred nodes; a device kernel would be pure overhead).

Host copy of ``pmarlo_tpu/utils/scc.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def strongly_connected_components(adjacency: np.ndarray) -> List[List[int]]:
    """Tarjan's SCC (iterative). ``adjacency[i, j]`` truthy means edge i->j."""
    adj = np.asarray(adjacency)
    n = adj.shape[0]
    successors = [np.nonzero(adj[i])[0].tolist() for i in range(n)]

    index_counter = 0
    stack: List[int] = []
    on_stack = np.zeros(n, dtype=bool)
    index = np.full(n, -1, dtype=np.int64)
    lowlink = np.full(n, -1, dtype=np.int64)
    result: List[List[int]] = []

    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            node, child_i = work[-1]
            if child_i == 0:
                index[node] = index_counter
                lowlink[node] = index_counter
                index_counter += 1
                stack.append(node)
                on_stack[node] = True
            advanced = False
            succ = successors[node]
            while child_i < len(succ):
                child = succ[child_i]
                child_i += 1
                if index[child] == -1:
                    work[-1] = (node, child_i)
                    work.append((child, 0))
                    advanced = True
                    break
                elif on_stack[child]:
                    lowlink[node] = min(lowlink[node], index[child])
            if advanced:
                continue
            work.pop()
            if lowlink[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(int(w))
                    if w == node:
                        break
                result.append(comp)
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
    return result


def analyse_scc(counts: np.ndarray) -> Dict[str, object]:
    """SCC summary of a count matrix (reference utils/scc.py:69)."""
    counts = np.asarray(counts)
    comps = strongly_connected_components(counts > 0)
    sizes = sorted((len(c) for c in comps), reverse=True)
    largest = max(comps, key=len) if comps else []
    return {
        "n_components": len(comps),
        "component_sizes": sizes,
        "largest_component": sorted(int(i) for i in largest),
        "is_connected": len(comps) <= 1,
    }


__all__ = ["strongly_connected_components", "analyse_scc"]
