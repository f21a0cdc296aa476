"""Experts a decode step's moe layer gives rows to, on the mean over every
decode iteration of the run (``moe_experts_touched.decode_<lanes>`` over
``moe_layer_runs.decode_<lanes>``, summed over lane counts): the experts
whose weights decode reads, which set its bytes.  None where the program
keeps no such counters."""


def read(run):
    st = run.stats
    runs = sum(v for k, v in st.items()
               if k.startswith("moe_layer_runs.decode_"))
    touched = sum(v for k, v in st.items()
                  if k.startswith("moe_experts_touched.decode_"))
    return touched / runs if runs else None
