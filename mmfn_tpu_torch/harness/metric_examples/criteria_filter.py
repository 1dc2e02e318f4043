"""Filter the recording's criteria into a pass/fail JSON — the criteria-usage
example metric (reference srunner/metrics/examples/criteria_filter.py:21-46;
the recording already carries the same {test_status, actual_value,
expected_value_success} fields per criterion).

The port's own copy of ``examples/metrics/criteria_filter.py``."""

import json
import os

from mmfn_tpu_torch.harness.metrics_log import BasicMetric


class CriteriaFilter(BasicMetric):

    def _create_metric(self, town_map, log, criteria):
        self.results = {
            name: {
                "test_status": c["test_status"],
                "actual_value": c["actual_value"],
                "success_value": c["expected_value_success"],
            }
            for name, c in (criteria or {}).items()
        }
        with open(os.path.join(self.out_dir,
                               "CriteriaFilter_results.json"), "w") as f:
            json.dump(self.results, f, sort_keys=False, indent=4)
