"""ops of the PyTorch port (see the package docstring).

``KERNELS`` lists every kernel wrapper of the port; each counts its launches
in its ``launches`` attribute.
"""

from .device_reduce import (bincount_add_into, coverage_add_into, coverage_add_reads_into,
                            coverage_add_records_into, coverage_finalize_into,
                            pileup_add_records_into, region_sums_into, threshold_runs)
from .pallas_kernels import (insert_scan_into, readqc_batch_into,
                             readqc_tails_into, readqc_unpack_into)
from .seqpurge import (adapter_evidence_into, adapter_scan_into,
                       seqpurge_decide_into)

KERNELS = (readqc_unpack_into, readqc_batch_into, readqc_tails_into,
           insert_scan_into, adapter_evidence_into, adapter_scan_into,
           seqpurge_decide_into, coverage_add_into, coverage_finalize_into,
           bincount_add_into, region_sums_into, threshold_runs,
           coverage_add_records_into, coverage_add_reads_into,
           pileup_add_records_into)
