from .registry import (ModelBundle, build_draft_model, build_model,
                       check_draft_pair)

__all__ = ["ModelBundle", "build_draft_model", "build_model",
           "check_draft_pair"]
