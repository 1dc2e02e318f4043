from mmfn_tpu_torch.serving.export import (export_forward, load_exported, save_exported,
                                           serving_call)

__all__ = ["export_forward", "save_exported", "load_exported", "serving_call"]
