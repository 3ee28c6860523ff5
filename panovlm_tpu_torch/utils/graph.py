"""Small undirected-graph toolkit for the SfM control plane (host), in place
of the networkx calls of the JAX package (models/sfm.py filter_by_triplet
and largest_biconnected, models/rotation_averaging.py spanning_tree_init,
the triplet search of models/translation_averaging.py).

The results of those callers depend on iteration order (the triplet filter
stops at the first consistent triangle; the spanning tree keeps the first
of equal-weight edges), so `Graph` keeps networkx's orders: nodes and each
node's neighbours in insertion order, edges visited node by node without
repeats, Kruskal's edges stably sorted by weight, breadth-first search in
neighbour order, components in node order.
"""

from __future__ import annotations


class Graph:
    def __init__(self):
        self.adj: dict = {}            # node -> {neighbour: edge data dict}

    def add_node(self, n):
        self.adj.setdefault(n, {})

    def add_edge(self, u, v, **attr):
        self.add_node(u)
        self.add_node(v)
        data = self.adj[u].get(v, {})
        data.update(attr)
        self.adj[u][v] = data
        self.adj[v][u] = data

    def has_edge(self, u, v):
        return u in self.adj and v in self.adj[u]

    def remove_edge(self, u, v):
        del self.adj[u][v]
        if u != v:
            del self.adj[v][u]

    def number_of_edges(self):
        return sum(len(nb) for nb in self.adj.values()) // 2

    def edges(self, data: bool = False):
        """Each edge once: node by node, neighbours in insertion order."""
        seen = set()
        for n, nbrs in self.adj.items():
            for nb, d in nbrs.items():
                if nb not in seen:
                    yield (n, nb, d) if data else (n, nb)
            seen.add(n)

    def copy(self):
        g = Graph()
        for n in self.adj:
            g.add_node(n)
        for u, v, d in self.edges(data=True):
            g.add_edge(u, v, **d)
        return g


def common_neighbors(g: Graph, u, v) -> set:
    """networkx.common_neighbors: the neighbours of both u and v, as a set
    (callers sort it)."""
    return g.adj[u].keys() & (g.adj[v].keys() - {u, v})


def connected_components(g: Graph):
    """Components as sets, in the order of their first node."""
    seen = set()
    for s in g.adj:
        if s in seen:
            continue
        comp, frontier = {s}, [s]
        while frontier:
            nxt = []
            for v in frontier:
                for w in g.adj[v]:
                    if w not in comp:
                        comp.add(w)
                        nxt.append(w)
            frontier = nxt
        seen |= comp
        yield comp


def bridges(g: Graph):
    """Set of bridge edges (u, v) (iterative DFS low-link)."""
    disc, low, out, t = {}, {}, set(), 0
    for root in g.adj:
        if root in disc:
            continue
        disc[root] = low[root] = t
        t += 1
        stack = [(root, None, iter(g.adj[root]))]
        while stack:
            v, parent, it = stack[-1]
            advanced = False
            for w in it:
                if w == parent:
                    continue
                if w in disc:
                    low[v] = min(low[v], disc[w])
                else:
                    disc[w] = low[w] = t
                    t += 1
                    stack.append((w, v, iter(g.adj[w])))
                    advanced = True
                    break
            if not advanced:
                stack.pop()
                if parent is not None:
                    low[parent] = min(low[parent], low[v])
                    if low[v] > disc[parent]:
                        out.add((parent, v))
    return out


def maximum_spanning_tree(g: Graph, weight: str = "weight"):
    """Kruskal over the edges stably sorted by descending weight; the tree
    holds every node of g and the accepted edges in acceptance order."""
    parent = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    edges = sorted(((d.get(weight, 1), u, v, d) for u, v, d in g.edges(data=True)),
                   key=lambda e: e[0], reverse=True)
    tree = Graph()
    for n in g.adj:
        tree.add_node(n)
    for _, u, v, d in edges:
        ru, rv = find(u), find(v)
        if ru != rv:
            tree.add_edge(u, v, **d)
            parent[ru] = rv
    return tree


def bfs_edges(g: Graph, source):
    """(parent, child) edges of a breadth-first search, neighbours in
    insertion order."""
    seen = {source}
    level = [source]
    while level:
        nxt = []
        for p in level:
            for c in g.adj[p]:
                if c not in seen:
                    seen.add(c)
                    nxt.append(c)
                    yield p, c
        level = nxt
