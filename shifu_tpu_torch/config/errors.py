"""Error-code taxonomy — the port's copy of ``shifu_tpu.config.errors``
(reference ``exception/ShifuErrorCode.java`` + ``ShifuException.java``):
every user-facing failure carries a stable numeric code and message, the
same codes in both packages.
"""

from __future__ import annotations

import enum


class ErrorCode(enum.Enum):
    # --- input / filesystem (1000s)
    ERROR_INPUT_NOT_FOUND = (1001, "The input data is not found")
    ERROR_HEADER_NOT_FOUND = (1002, "The header is not found")
    ERROR_LOAD_MODELCONFIG = (1003, "Could not load ModelConfig")
    ERROR_WRITE_MODELCONFIG = (1004, "Could not write ModelConfig file")
    ERROR_LOAD_COLCONFIG = (1005, "Could not load ColumnConfig")
    ERROR_WRITE_COLCONFIG = (1006, "Could not write ColumnConfig file")
    ERROR_REMOTE_SOURCE = (1007, "Remote source type needs staging to a "
                                 "local path")
    ERROR_NO_EVAL_SET = (1015, "No eval set configured")
    # --- config validation (1050s)
    ERROR_MODELCONFIG_NOT_VALIDATION = (
        1051, "The ModelConfig file did not pass the validation")
    ERROR_UNSUPPORT_ALG = (1052, "Unsupported algorithm")
    ERROR_GRIDCONFIG_NOT_VALIDATION = (
        1055, "The grid search config did not pass the validation")
    # rebuild-specific: ordered-pipeline precondition (the reference's
    # cluster steps fail inside Pig/Hadoop instead)
    ERROR_STEP_PRECONDITION = (
        1061, "A prerequisite pipeline step has not run")
    # rebuild-specific: a step's commit journal says its artifacts are
    # torn/incomplete (crash-consistency layer, pipeline/journal.py)
    ERROR_TORN_ARTIFACT = (
        1062, "A pipeline artifact is torn or incomplete")
    # rebuild-specific: the multi-controller coordinator connect retry
    # ladder exhausted (parallel/mesh.initialize_distributed) — raised
    # coded instead of hanging the launcher on a dead coordinator
    ERROR_DCN_CONNECT = (
        1063, "Could not connect to the distributed coordinator")
    # --- data shape (1150s)
    ERROR_EXCEED_COL = (1151, "Input data has more fields than the header")
    ERROR_LESS_COL = (1152, "Input data has fewer fields than the header")
    ERROR_NO_EQUAL_COLCONFIG = (
        1153, "Input data length is not equal to column config size")
    ERROR_NO_TARGET_COLUMN = (1154, "No target column in training data")
    ERROR_INVALID_TARGET_VALUE = (1155, "Invalid target value")
    # rebuild-specific: quarantined bad rows/shards exceeded
    # shifu.data.badThreshold (bounded bad-input tolerance)
    ERROR_BAD_DATA_THRESHOLD = (
        1156, "Malformed input exceeded the configured bad-data threshold")
    # --- models (1250s)
    ERROR_MODEL_FILE_NOT_FOUND = (1250, "The model file is not found")
    ERROR_FAIL_TO_LOAD_MODEL_FILE = (1251, "Failed to load the model file")
    # rebuild-specific: a trainer-state checkpoint was written under a
    # different shifu.train.precision than the resuming run — silently
    # casting the master copy / optimizer state would corrupt the resume
    ERROR_CHECKPOINT_PRECISION_MISMATCH = (
        1252, "Checkpoint precision does not match shifu.train.precision")
    # --- eval (1300s)
    ERROR_MODEL_EVALSET_DOESNT_EXIST = (1301, "The evalset doesn't exist")
    ERROR_MODEL_EVALSET_ALREADY_EXIST = (1302, "The evalset already exists")
    ERROR_EVAL_SELECTOR_EMPTY = (
        1305, "performanceScoreSelector is empty or not set properly")

    def __init__(self, code: int, message: str):
        self.code = code
        self.message = message


class ShifuError(Exception):
    """Base error with a stable code (reference ``ShifuException``)."""

    def __init__(self, error_code: ErrorCode, detail: str = ""):
        self.error_code = error_code
        msg = f"[{error_code.code}] {error_code.message}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
