"""Union-find feature tracks (util/Tracks.{h,cpp} of the reference,
UnionFind :34-107, PointTrack assembly :109-133): the port's copy of
panovlm_tpu/utils/tracks.py (host control plane). `UnionFind` also serves
models/line_tracks.py."""

from __future__ import annotations

import numpy as np


class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int32)

    def find(self, x):
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.rank[ra] += self.rank[ra] == self.rank[rb]


def build_tracks(pair_matches, n_features_per_image, min_length: int = 2,
                 max_length: int | None = None):
    """Tracks from per-pair matches [(img_i, img_j, (K,2) feature ids)].
    Returns padded (track_img (T, L) int32, track_feat (T, L) int32, mask
    (T, L)), observations in image order; tracks seen in fewer than
    min_length images, or where one image holds two of its features, are
    dropped."""
    n_img = len(n_features_per_image)
    offsets = np.zeros(n_img + 1, np.int64)
    for i in range(n_img):
        offsets[i + 1] = offsets[i] + int(n_features_per_image[i])
    total = int(offsets[-1])
    uf = UnionFind(total)
    for i, j, m in pair_matches:
        if len(m) == 0:
            continue
        a = offsets[i] + np.asarray(m)[:, 0]
        b = offsets[j] + np.asarray(m)[:, 1]
        for x, y in zip(a, b):
            uf.union(int(x), int(y))
    observed = set()
    for i, j, m in pair_matches:
        if len(m) == 0:
            continue
        observed.update((offsets[i] + np.asarray(m)[:, 0]).tolist())
        observed.update((offsets[j] + np.asarray(m)[:, 1]).tolist())
    groups: dict[int, list[int]] = {}
    for node in observed:
        groups.setdefault(uf.find(int(node)), []).append(int(node))
    img_of = np.searchsorted(offsets, np.arange(total), side="right") - 1
    tracks = []
    for nodes in groups.values():
        imgs = img_of[nodes]
        uniq, counts = np.unique(imgs, return_counts=True)
        if (counts > 1).any() or len(uniq) < min_length:
            continue
        feats = np.asarray(nodes) - offsets[imgs]
        order = np.argsort(imgs)
        tracks.append((imgs[order], feats[order]))
    if not tracks:
        return (np.zeros((0, 1), np.int32), np.zeros((0, 1), np.int32),
                np.zeros((0, 1), bool))
    L = max(len(t[0]) for t in tracks)
    if max_length:
        L = min(L, max_length)
    T = len(tracks)
    track_img = np.zeros((T, L), np.int32)
    track_feat = np.zeros((T, L), np.int32)
    mask = np.zeros((T, L), bool)
    for k, (imgs, feats) in enumerate(tracks):
        n = min(len(imgs), L)
        track_img[k, :n] = imgs[:n]
        track_feat[k, :n] = feats[:n]
        mask[k, :n] = True
    return track_img, track_feat, mask
