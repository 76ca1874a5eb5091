"""Party runtime: actors + typed messages + the local, pipelined and
socket transports (`SocketTransport` + `netparty.PartyServer`, launched
by `launch/cluster.py`), the chaos link layer under the socket transport
(`FaultyTransport`: seeded faults, ARQ, lossless deflation), the wire
codec and the retry policy."""
from repro_torch.runtime import messages
from repro_torch.runtime.chaos import (ChaosProfile, ChaosStats,
                                       FaultSchedule, FaultyTransport)
from repro_torch.runtime.codec import Codec, CodecError
from repro_torch.runtime.party import CPState, DataParty, LabelParty, Party
from repro_torch.runtime.policy import RetryPolicy
from repro_torch.runtime.scheduler import (TransportDealer, VFLScheduler,
                                           mask_bound_bits,
                                           validate_key_bits)
from repro_torch.runtime.session import TrainState
from repro_torch.runtime.transport import (LocalTransport, LockedRNG,
                                           PipelinedTransport,
                                           SocketTransport, Transport)

__all__ = [
    "messages", "Party", "DataParty", "LabelParty", "CPState",
    "VFLScheduler", "TransportDealer", "mask_bound_bits",
    "validate_key_bits", "Transport", "LocalTransport",
    "PipelinedTransport", "SocketTransport", "LockedRNG",
    "TrainState", "Codec", "CodecError", "RetryPolicy", "ChaosProfile",
    "ChaosStats", "FaultSchedule", "FaultyTransport",
]
