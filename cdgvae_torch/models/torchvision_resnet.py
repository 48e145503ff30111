"""A ResNet-18 whose ``state_dict()`` is torchvision's, key for key.

The port's own copy of the network of ``scripts/celeba_pretrain_torch.py``
(NCHW, ``nn.Conv2d``/``nn.BatchNorm2d`` at PyTorch's default inits, built
in the same order, so the same generator state gives the same weights).
Its state dict (``conv1.weight``, ``bn1.*``, ``layer{1-4}.{0,1}.{conv,bn}
{1,2}.*``, ``layer{2-4}.0.downsample.{0,1}.*``, ``fc.*``, BatchNorm's
``running_mean``, ``running_var`` and ``num_batches_tracked`` included) is
what ``models/resnet.py::ResNetEncoder.load_torch_weights`` and the JAX
package's importer read; both ignore the ``fc`` head, which is sized here
for the 6 CelebA attributes of the pretraining task
(``tools/celeba_pretrain.py``).
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn


class BasicBlock(nn.Module):
    """torchvision-layout basic block: conv1/bn1/conv2/bn2[/downsample]."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
                nn.BatchNorm2d(out_ch))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + identity)


class ResNet18(nn.Module):
    """ResNet-18 in torchvision's layout with an ``n_out`` fc head. The
    weights are drawn on the CPU from the global generator, then moved to
    ``device``, so a card starts from the CPU's weights."""

    def __init__(self, n_out: int = 6, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_ch = 64
        for li, w in enumerate([64, 128, 256, 512]):
            blocks = []
            for bi in range(2):
                stride = 2 if (li > 0 and bi == 0) else 1
                blocks.append(BasicBlock(in_ch, w, stride))
                in_ch = w
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(512, n_out)
        keys = set(self.state_dict())
        if not {"conv1.weight", "layer4.1.bn2.running_var",
                "layer2.0.downsample.1.num_batches_tracked"} <= keys:
            raise RuntimeError("the ResNet-18 is not in torchvision's layout")
        if device is not None:
            self.to(device)

    def forward(self, x):
        h = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for li in range(1, 5):
            h = getattr(self, f"layer{li}")(h)
        return self.fc(h.mean(dim=(2, 3)))
