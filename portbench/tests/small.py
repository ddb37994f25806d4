"""Each cell at a size a CPU test run holds: the same drivers, references
and readers, with the configuration's and the mix's sizes cut."""

KMEANS = {"config": {"d": 32, "k": 8, "chunk_points": 512,
                     "assumed": {"mixture": {"components": 8,
                                             "mean_std": 1.0,
                                             "sigma": 1.0}}},
          "traffic": {"chunks": 4, "trace_chunks": 2}}
MFSGD = {"config": {"n_users": 600, "n_items": 300, "nnz": 20000,
                    "rank": 8, "u_tile": 64, "i_tile": 64,
                    "entry_cap": 128},
         "traffic": {"min_per_user": 5, "item_id_jitter": 16,
                     "trace_epochs": 2}}

SMALL = {"kmeans_stream.int8.n1e9": KMEANS,
         "kmeans_stream.f32.n1e8": KMEANS,
         "mfsgd.ml20m.zipf": MFSGD,
         "mfsgd.ml20m.uniform": MFSGD}
