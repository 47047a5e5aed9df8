"""How the reference follows the program's discrete choices.

A detector makes choices that rounding can flip: which encoder tokens
become proposals, which (query, class) pairs the top-k keeps, which class
channel a mask is decoded from. To compare the values that follow a choice,
the reference takes the program's choice, handed to it in `forced`, and
keeps in `seen` its own choice and the scores it made it from, so that the
benchmark judges each of the program's choices by how far below the
reference's own it lies.
"""

import torch


class Follow:
    forced: dict
    seen: dict

    def follow(self, name, own, scores):
        self.seen[name] = (own, scores)
        return self.forced.get(name, own)


def take_topk(logits, boxes, q, labels, canvas_hw):
    """`postprocess.select_topk`'s scores and xyxy pixel boxes at given
    (query, class) pairs q, labels (B, K)."""
    prob = torch.sigmoid(logits.float())
    scores = torch.gather(prob, 1, q[..., None].expand(
        -1, -1, prob.shape[-1])).gather(2, labels[..., None])[..., 0]
    bx = torch.gather(boxes.float(), 1, q[..., None].expand(-1, -1, 4))
    xy = torch.cat([bx[..., :2] - bx[..., 2:] * 0.5,
                    bx[..., :2] + bx[..., 2:] * 0.5], dim=-1)
    h, w = canvas_hw
    return scores, xy * torch.tensor([w, h, w, h], dtype=torch.float32,
                                     device=xy.device)
