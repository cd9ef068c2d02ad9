from clsurvey_torch.engine.train import (  # noqa: F401
    Engine,
    EngineContext,
    TrainJob,
    TrainState,
    make_context,
)
