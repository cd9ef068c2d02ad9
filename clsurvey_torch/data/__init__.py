from clsurvey_torch.data.registry import (  # noqa: F401
    TaskData,
    TaskSequence,
    parse,
    register_dataset,
    merge_tasks,
)
