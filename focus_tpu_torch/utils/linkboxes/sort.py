"""Pre-linked box tracks to fixed object slots (counterpart of
``sort_boxes_sorted`` in ``focus_tpu/utils/linkboxes/sort.py``). The SORT
tracker itself links boxes offline, before a dataset is read, and is not
ported."""

from __future__ import annotations

import numpy as np


def sort_boxes_sorted(vid_boxes, O, saved_indices=()):
    """Pre-linked boxes [n, 5] (xyxy + track id) a frame -> [O, T, 4];
    ``saved_indices`` pin the given track ids to the first slots (hands).
    Further ids take the next slot in order of first appearance; ids past
    slot O - 1 are dropped."""
    global2local = {idx: i for i, idx in enumerate(sorted(saved_indices))}

    def getidx(g):
        if g not in global2local:
            global2local[g] = len(global2local)
        return global2local[g]

    T = len(vid_boxes)
    out = np.zeros([T, O, 4])
    for fidx, boxes in enumerate(vid_boxes):
        boxes = np.asarray(boxes, np.float64).reshape(-1, 5)
        for row in boxes:
            slot = getidx(int(row[4]))
            if slot < O:
                out[fidx, slot] = row[:4]
    return out.transpose([1, 0, 2])
