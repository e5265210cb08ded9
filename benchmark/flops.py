"""Floating-point operations of the PPO agent a sample, from a
configuration's shapes.

The agent is the IMPALA CNN torso (a strided stem conv, ConvSequences of a
3x3 conv, a 3x3/2 "SAME" max pool and residual blocks of two 3x3 convs,
then a dense layer) under an actor (dense layers, one categorical head per
action dimension) and a critic (dense layers, one value).  Operations are
counted as ``torch.utils.flop_counter.FlopCounterMode`` counts them: 2 a
multiply-add of every convolution and matrix product, nothing for biases,
activations, pools or residual adds.  Backward, each layer computes its
weight's gradient and, but for the stem (its input, the observation, has
none), its input's, each as many operations as its forward.
"""

from __future__ import annotations


def _layers(cfg: dict):
    """``(forward operations, takes an input gradient)`` of each layer for
    one sample of ``cfg``'s grid."""
    net = cfg["network"]
    h, w, cin = cfg["nrows"], cfg["ncols"], 3
    stem = net["stem"]
    k, s = stem["kernel"], stem["stride"]
    h, w = (h - k) // s + 1, (w - k) // s + 1  # VALID
    layers = [(2 * h * w * stem["channels"] * cin * k * k, False)]
    cin = stem["channels"]
    for c in net["conv_sequences"]:
        layers.append((2 * h * w * c * cin * 9, True))
        h, w = -(-h // 2), -(-w // 2)  # the SAME pool, stride 2
        layers += [(2 * h * w * c * c * 9, True)] * (2 * net["residual_blocks"])
        cin = c
    layers.append((2 * h * w * cin * net["dense"], True))
    for widths, outs in ((net["actor"], sum(cfg["action_heads"])), (net["critic"], 1)):
        fan_in = net["dense"]
        for width in list(widths) + [outs]:
            layers.append((2 * fan_in * width, True))
            fan_in = width
    return layers


def forward(cfg: dict) -> int:
    """Operations of one sample through the torso, the actor and the
    critic."""
    return sum(f for f, _ in _layers(cfg))


def forward_backward(cfg: dict) -> int:
    """Operations of one sample through the forward and the backward pass
    of the loss: every weight's gradient, every input's but the stem's."""
    return sum(f * (3 if grad_in else 2) for f, grad_in in _layers(cfg))
