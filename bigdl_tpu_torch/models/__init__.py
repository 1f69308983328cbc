"""Models and serving of the port (counterpart of ``bigdl_tpu/models``):
the transformer LM, its generation loop (beam search and
``generate_speculative`` too), the bucketed ``LMServer``, the
continuous-batching ``ContinuousLMServer`` (``models.serving``) with its
prefix cache (``models.prefix_cache``), the fleet router
(``models.router.LMRouter``), and ResNet (``resnet.build``,
``resnet.build_cifar``)."""

from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.models import transformer
from bigdl_tpu_torch.models.generation import generate, generate_speculative
from bigdl_tpu_torch.models.lm_server import LMServer, make_http_server
from bigdl_tpu_torch.models.router import LMRouter
from bigdl_tpu_torch.models.serving import ContinuousLMServer
