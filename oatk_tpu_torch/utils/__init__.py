from .log import log_info, log_warn, log_error, realtime0
