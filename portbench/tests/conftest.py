"""The small sizes of the cells added after ``small.py`` was written,
entered into its maps (``CONFIG``, ``TRAFFIC``, ``T``) before any test
here runs, so that ``small_cell`` serves every cell of
``BENCHMARK.json``."""

from portbench.tests import small

# b2t_gru: 5 days of 4 trials, batches of 2 days x 4 trials (B 8) of
# 12-30 frames of 6 features, windows of 3 every 2, 3 layers of 16
small.CONFIG.setdefault("b2t_gru", {"in_channels": 6, "hidden": 16,
                                    "n_layers": 3, "n_days": 5,
                                    "win_size": 3, "stride": 2})
small.TRAFFIC.setdefault("train_days", {
    "trials_per_day": 4, "days_per_batch": 2, "trials_per_day_batch": 4,
    "batch_rows": 8, "len_lo": 12, "len_hi": 30, "profile_steps": 2})
small.T.setdefault("b2t_gru", 30)
