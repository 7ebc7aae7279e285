"""Default site scripts (the stanford-*.script analogues).

These encode the paper's Discussion list verbatim: every category the
pipeline must exclude, plus the Basic Application Confidentiality Profile
(Clean Graphics + Retain Longitudinal Temporal Information With Modified
Dates) tag policy for the anonymizer.
"""
from __future__ import annotations

from repro_torch.core.rules import emit_scrub_script

# Paper Discussion, items 1-3: categorical exclusions.
DEFAULT_FILTER_SCRIPT = """
# stanford-filter.script (reproduction)
# 1. analog film digitizers: PHI anywhere on film, any orientation
reject Manufacturer equals "Vidar"
# 2a. encapsulated PDF documents
reject SOPClassUID startswith "1.2.840.10008.5.1.4.1.1.104"
# 2b. structured report documents
reject Modality in "SR,KO"
reject SOPClassUID startswith "1.2.840.10008.5.1.4.1.1.88"
# 2c. presentation state objects
reject Modality equals "PR"
reject SOPClassUID startswith "1.2.840.10008.5.1.4.1.1.11"
# 2d. uncommon modality attributes
reject Modality in "RAW,OT,DOC,PLAN"
# 2e. secondary capture objects (*bypassable)
reject SOPClassUID startswith "1.2.840.10008.5.1.4.1.1.7" unless trusted_sc_station
# 2f. burned-in annotation declared by the device (*bypassable)
reject BurnedInAnnotation equals "YES" unless trusted_sc_station
# 2g. ConversionType present but empty
reject ConversionType equals ""
# 2h. derived / secondary image types (*bypassable)
reject ImageType contains "DERIVED" unless derived_localizer
reject ImageType contains "SECONDARY" unless derived_localizer
# 3. video capture devices
reject builtin:video_sop_class
# ultrasound is whitelist-only (paper Table 2)
reject builtin:us_not_whitelisted
# images without pixel geometry cannot be scrubbed -> reject
reject Rows missing
reject Columns missing
"""

# DICOM Basic Application Confidentiality Profile + Clean Graphics +
# Retain Longitudinal Temporal Information With Modified Dates.
DEFAULT_ANONYMIZER_SCRIPT = """
# stanford-anonymizer.script (reproduction)
set AccessionNumber @param(accession)
set PatientID @param(mrn)
set PatientName @param(mrn)
remove PatientBirthDate
remove PatientBirthTime
keep PatientSex
keep PatientAge
remove OtherPatientIDs
remove OtherPatientNames
remove PatientAddress
remove PatientTelephoneNumbers
remove AdditionalPatientHistory
remove ReferringPhysicianName
remove PhysiciansOfRecord
remove PerformingPhysicianName
remove OperatorsName
remove InstitutionName
remove InstitutionAddress
remove InstitutionalDepartmentName
remove DeviceSerialNumber
remove StationName
jitterdate StudyDate
jitterdate SeriesDate
jitterdate AcquisitionDate
jitterdate ContentDate
empty StudyTime
empty SeriesTime
empty AcquisitionTime
empty ContentTime
hashuid SOPInstanceUID
hashuid StudyInstanceUID
hashuid SeriesInstanceUID
set StudyID @param(accession)
keep SeriesNumber
keep InstanceNumber
keep Modality
keep Manufacturer
keep ManufacturerModelName
keep SoftwareVersions
keep Rows
keep Columns
keep BitsAllocated
keep BitsStored
keep SamplesPerPixel
keep BurnedInAnnotation
keep ImageType
keep ConversionType
keep BodyPartExamined
keep SOPClassUID
keep TransferSyntaxUID
removeprivate
removefreetext
default remove
"""

# The scrubber script is generated from the device registry (DESIGN.md §3).
DEFAULT_SCRUB_SCRIPT = emit_scrub_script("stanford-scrubber.script (reproduction)")
