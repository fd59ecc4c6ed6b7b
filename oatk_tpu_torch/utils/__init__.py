from .log import log_info, log_warn, log_error, timed_stage, realtime0, stage_timer
