from .model_config import (  # noqa: F401
    Algorithm, ModelConfig, ModelNormalizeConf, ModelTrainConf, NormType,
    PrecisionType, RawSourceData,
)
from .column_config import (  # noqa: F401
    ColumnBinning, ColumnConfig, ColumnFlag, ColumnStats, ColumnType,
    build_initial_column_configs, load_column_configs, save_column_configs,
    selected_columns,
)
