"""Demo plot config (ref:src/utilities/plot_configs/demo.py:1-57); the
counterpart of ``clsurvey_tpu/utilities/plot_configs/demo.py``.

Collects every method's eval results for one (dataset, model, gridsearch)
combination and renders the per-task accuracy curves + summary table.

Run:  python -m clsurvey_torch.utilities.plot_configs.demo \
          [ds_name] [model_name] [gridsearch_name]
"""

import sys

from clsurvey_torch.utils.config import load_config
from clsurvey_torch.utilities.postprocessing import (
    analyze_experiments, collect_gridsearch_exp_entries)

METHODS = ["SI", "EWC", "MAS", "mean_IMM", "mode_IMM", "LWF", "EBLL",
           "GEM", "ICARL", "packnet", "HAT", "pathnet", "finetuning",
           "joint", "finetuning_rehearsal_partial_mem",
           "finetuning_rehearsal_full_mem"]


def main(ds_name="tiny", model_name="small_VGG9_cl_128_128",
         gridsearch_name="demo", save_img="demo_plot"):
    cfg = load_config()
    entries = []
    for method in METHODS:
        entries.extend(collect_gridsearch_exp_entries(
            cfg.test_results_root_path, ds_name, method, model_name,
            gridsearch_name))
    if not entries:
        print(f"No results under {cfg.test_results_root_path} for "
              f"{ds_name}/{model_name}/{gridsearch_name}")
        return []
    analyze_experiments(entries, plot_seq_acc=True,
                        plot_seq_forgetting=True,
                        save_img_path=save_img)
    return entries


if __name__ == "__main__":
    main(*sys.argv[1:])
