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
# ~84k tokens: entries of 2,048 slots in chunks of 256, and a most
# frequent word counted past 256 in every topic, so that bf16 gathers (the
# control) round counts that K4 reads.  The band's centre is this size's
# reference chain (Driver.chain) after each sweep, the median over 14
# seeds; on them the chain and the program agree on every token, and their
# widest gap from the centre is 9.4e-4, under the limit 4e-3.
LDA = {"config": {"n_docs": 2048, "vocab_size": 64, "n_topics": 4,
                  "d_tile": 64, "w_tile": 16},
       "traffic": {"doc_len_mean": 40, "true_topics": 4,
                   "prefix_chunks": 64, "ll_center": [-4.8661, -4.8037],
                   "limits": {"count_gap": 0, "prefix_mismatch": 0,
                              "rotate_mismatch": 0, "ll_gap": 4e-3}}}

SMALL = {"kmeans_stream.int8.n1e9": KMEANS,
         "kmeans_stream.f32.n1e8": KMEANS,
         "mfsgd.ml20m.zipf": MFSGD,
         "mfsgd.ml20m.uniform": MFSGD,
         "lda.enwiki1m.zipf": LDA}
