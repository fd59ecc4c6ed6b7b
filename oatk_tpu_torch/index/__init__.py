from .syncmer_db import SyncmerDB, collect_syncmer_db
from .histogram import analyze_count_peaks, count_histogram
