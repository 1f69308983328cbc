"""Models and serving of the port (counterpart of ``bigdl_tpu/models``):
the transformer LM, its generation loop (beam search and
``generate_speculative`` too), the bucketed ``LMServer``, the
continuous-batching ``ContinuousLMServer`` (``models.serving``) with its
prefix cache (``models.prefix_cache``), the fleet router
(``models.router.LMRouter``), ResNet (``resnet.build``,
``resnet.build_cifar``) and the classic conv zoo (``lenet``, ``vgg``,
``inception``, ``alexnet``)."""

from bigdl_tpu_torch.models import (alexnet, inception, lenet, resnet,
                                    transformer, vgg)
from bigdl_tpu_torch.models.generation import generate, generate_speculative
from bigdl_tpu_torch.models.lm_server import LMServer, make_http_server
from bigdl_tpu_torch.models.router import LMRouter
from bigdl_tpu_torch.models.serving import ContinuousLMServer
