"""COCO-compatible RLE mask codec (numpy, no pycocotools); copy of
`boxer_tpu/utils/rle.py`.

Implements the pycocotools `mask.encode`/`decode` format: column-major
(Fortran) run-length counts, compressed to the COCO LEB128-style ascii string.
Used for segmentation eval output (`reference dataset/coco.py:160-171` emits
compressed RLE via mask_util.encode) and for decoding crowd-region RLE
annotations.
"""

from typing import Dict, List

import numpy as np


def mask_to_rle_counts(mask: np.ndarray) -> List[int]:
    """Binary mask (H, W) -> uncompressed counts (column-major runs,
    starting with a (possibly zero) run of 0s)."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    if flat.size == 0:
        return [0]
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return runs


def rle_counts_to_mask(counts: List[int], h: int, w: int) -> np.ndarray:
    total = h * w
    flat = np.zeros(total, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F").astype(bool)


def encode_counts(counts: List[int]) -> str:
    """Compress counts to the COCO ascii string (pycocotools rleToString)."""
    out = []
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def decode_counts(s: str) -> List[int]:
    """Decompress the COCO ascii string (pycocotools rleFrString)."""
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode_mask(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> {"size": [h, w], "counts": str}."""
    h, w = mask.shape
    return {"size": [h, w],
            "counts": encode_counts(mask_to_rle_counts(mask))}


def decode_rle(rle: Dict) -> np.ndarray:
    """{"size": [h, w], "counts": str|list} -> binary (H, W) mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = decode_counts(counts)
    return rle_counts_to_mask(counts, h, w)


def rle_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = decode_counts(counts)
    return int(sum(counts[1::2]))


def rle_iou_matrix(dt_rles: List[Dict], gt_rles: List[Dict],
                   iscrowd: List[bool]) -> np.ndarray:
    """Pairwise mask IoU (dt × gt) with crowd semantics (pycocotools iou):
    for crowd gt, union = area(dt)."""
    if not dt_rles or not gt_rles:
        return np.zeros((len(dt_rles), len(gt_rles)))
    dts = [decode_rle(r) for r in dt_rles]
    gts = [decode_rle(r) for r in gt_rles]
    d_flat = np.stack([m.reshape(-1) for m in dts]).astype(np.float32)
    g_flat = np.stack([m.reshape(-1) for m in gts]).astype(np.float32)
    inter = d_flat @ g_flat.T
    d_area = d_flat.sum(1)[:, None]
    g_area = g_flat.sum(1)[None, :]
    union = d_area + g_area - inter
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, d_area, union)
    return inter / np.maximum(union, 1e-9)
