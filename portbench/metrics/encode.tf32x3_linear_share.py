"""encode.tf32x3_linear_share: the 3xTF32 GEMM's launches (`gemm_tf32x3.
launches`) over the launches the BERT rung's chunks call for, 4 a layer a
chunk (q/k/v fused, the attention output, the intermediate, the output)
times `num_hidden_layers` times the chunks the rung planned (`bert.
encode_chunks`), both as the program counted them since the process
started (set-up, window and the traced run's host-profiled requests), in %.
None where the program keeps no such counter or planned no chunk."""
import sys


def read(rec):
    gemm = sys.modules.get("ultrafnd_git_tpu_torch.kernels.gemm_tf32x3")
    bert = sys.modules.get("ultrafnd_git_tpu_torch.models.bert")
    launches = getattr(gemm, "launches", None)
    chunks = getattr(bert, "encode_chunks", 0)
    if launches is None or not chunks:
        return None
    return 100.0 * launches / (4 * rec["cfg"]["num_hidden_layers"] * chunks)
