"""Models with the JAX package's parameter layout and leaf order.

* ``lenet``         — MNIST CNN (JAX's Threefry init, ``threefry``)
* ``resnet_cifar``  — the cifar10-fast DAWNBench net
* ``resnet``        — ResNet-50/101/152 v1.5
* ``transformer``   — BERT-style encoder (BERT-base + PowerSGD)
* ``vgg``           — VGG-11/13/16/19, with and without BatchNorm
"""
