"""Models and serving of the port (counterpart of ``bigdl_tpu/models``):
the transformer LM, its generation loop and ``LMServer``, and ResNet
(``resnet.build``, ``resnet.build_cifar``)."""
