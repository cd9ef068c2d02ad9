from clsurvey_torch.models.registry import (  # noqa: F401
    parse_model_name,
    ModelSpec,
    create_init_model,
)
from clsurvey_torch.models import heads  # noqa: F401
