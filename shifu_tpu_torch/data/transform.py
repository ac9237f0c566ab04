"""Model-input column selection — the port's copy of
``shifu_tpu.data.transform.model_input_columns`` (the offline
``DatasetTransformer`` arrives with the norm slice)."""

from __future__ import annotations

from typing import List

from ..config import ColumnConfig, ModelConfig, selected_columns


def model_input_columns(model_config: ModelConfig,
                        column_configs: List[ColumnConfig]) -> List[ColumnConfig]:
    """Columns that feed the model: finalSelect if any, else all candidates
    with stats (norm can run before varselect)."""
    sel = selected_columns(column_configs)
    if sel:
        return sel
    return [c for c in column_configs
            if c.is_candidate() and c.num_bins() > 0]
